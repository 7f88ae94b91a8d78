"""RNG-schedule replay for trainer parity (port of
gsplat_tpu/train/replay.py, the same file format).

A schedule .npz holds a training loop's whole stochastic record: the
camera of each iteration by name (``camera_names``), the raw standard
normal noise of each iteration (``noise_{it:05d}``, [n, 3]) and, per
densification call j, the dead mask and relocation templates
(``dead_{j}``, ``reloc_t_{j}``), the alive count before growth and the
growth templates (``add_p_{j}``, ``add_t_{j}``) at iteration
``densify_iter_{j}``. tests/run_reference_trainer.py --record_rng records
one from the reference loop.

``python -m gsplat_tpu_torch.train.train_static --replay_rng <file>``
replays it verbatim, so two training loops fed the same schedule differ
only by float arithmetic. torch and JAX random streams differ; this is
how the port's trainer is held against the JAX one.
"""

from __future__ import annotations

import numpy as np


class ReplaySchedule:
    def __init__(self, path: str, capacity: int):
        with np.load(path, allow_pickle=False) as z:
            self._z = {k: z[k] for k in z.files}
        self.capacity = capacity
        self.camera_names = [str(s) for s in self._z["camera_names"]]
        self.iterations = len(self.camera_names)
        self._densify = {}
        j = 0
        while f"densify_iter_{j}" in self._z:
            self._densify[int(self._z[f"densify_iter_{j}"])] = j
            j += 1
        # agreement with the live state at each replayed densification
        self.diagnostics: list[dict] = []

    @property
    def num_densify(self) -> int:
        return len(self._densify)

    def camera_name(self, iteration: int) -> str:
        return self.camera_names[iteration - 1]

    def noise(self, iteration: int, dtype=np.float32) -> np.ndarray:
        """[capacity, 3] raw standard normal for this iteration; zeros where
        the schedule has none (the reference skips the final iteration,
        train_static.py:131)."""
        key = f"noise_{iteration:05d}"
        out = np.zeros((self.capacity, 3), dtype)
        if key in self._z:
            n = self._z[key]
            out[: len(n)] = n
        return out

    def has_densify(self, iteration: int) -> bool:
        return iteration in self._densify

    def densify_arrays(self, iteration: int, state=None):
        """(dead_mask [C], reloc_t [C], add_t [C], target) of the recorded
        densification at ``iteration``; the template maps are the identity
        at the rows they do not move (mcmc._relocate_with / _add_with).

        With ``state`` (a port GaussianState) it records the dead-mask
        hamming distance and the alive-count mismatch against the live
        state in ``diagnostics``."""
        j = self._densify[iteration]
        z = self._z
        c = self.capacity
        dead_rec = z[f"dead_{j}"]
        dead = np.zeros(c, bool)
        dead[: len(dead_rec)] = dead_rec
        reloc_t = np.arange(c, dtype=np.int32)
        rt = z[f"reloc_t_{j}"]
        if len(rt):
            dead_rows = np.nonzero(dead)[0]
            if len(dead_rows) != len(rt):
                raise ValueError(
                    f"densify@{iteration}: {len(dead_rows)} dead rows vs "
                    f"{len(rt)} recorded relocation templates")
            reloc_t[dead_rows] = rt
        p_before = int(z[f"add_p_{j}"])
        at = z[f"add_t_{j}"]
        target = p_before + len(at)
        add_t = np.arange(c, dtype=np.int32)
        if len(at):
            add_t[p_before:target] = at

        if state is not None:
            alive = state.alive_mask.cpu().numpy()
            opa = state.get_opacity()[:, 0].cpu().numpy()
            ours_dead = alive & (opa <= 0.005)
            self.diagnostics.append({
                "iteration": iteration,
                "dead_recorded": int(dead.sum()),
                "dead_ours": int(ours_dead.sum()),
                "dead_hamming": int((dead != ours_dead).sum()),
                "p_recorded": p_before,
                "p_ours": int(state.n_alive),
                "grown": len(at),
            })
        return dead, reloc_t, add_t, target
