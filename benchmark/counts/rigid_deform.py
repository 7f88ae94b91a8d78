"""Work of the screw motion of a SwinGS window frame over its live rows
(P = ``work["gaussians"]``), beside a served frame's own
(counts/view_frame.py, whose preprocess already reads each row's position
and rotation): each live row's own inputs to the motion read once, its
three velocities, three rotation-vector and three rotation-centre floats
and its start (40 B), and 118 float operations a row: the age (1), the
scaled rotation vector and shift (6), the angle (6: squares, sum, root),
the axis (3), sine and cosine of the angle and of its half (5), the
rotation quaternion's vector part (3), the rotation matrix (30: k k^T,
its (1 - cos) scale, sin [k]x, cos I, their sums), the offset from the
centre and back with the shift (9), the matrix-vector product (15), the
quaternion product (28) and its normalisation (12)."""

BYTES_PER_ROW = 40
OPS_PER_ROW = 118


def nbytes(work) -> float:
    return work["gaussians"] * BYTES_PER_ROW


def ops(work) -> float:
    return work["gaussians"] * OPS_PER_ROW
