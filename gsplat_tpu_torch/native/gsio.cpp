// gsio — native IO for gsplat_tpu_torch's data loader (a copy of the
// COLMAP parsers of gsplat_tpu/native/gsio.cpp; the port keeps its own,
// and packs streamable.dat records in gsplat_tpu_torch/utils/stream.py).
// The hot parsing loops of the loader in C++ instead of per-record Python:
//   - COLMAP points3D.bin parsing (variable-length track records)
//   - COLMAP images.bin parsing (variable-length name + 2D point records)
//
// Host code, not a device kernel: an optional accelerator of the numpy
// parsers in data/colmap.py, which give the same arrays.
// Exposed as a C ABI for ctypes (no pybind11 needed).
// Build: make -C gsplat_tpu_torch/native OUT=build/gsio   (or automatic via
// gsio.py)

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// COLMAP points3D.bin: header u64 count; per record:
//   id u64, xyz f64*3, rgb u8*3, error f64, track_len u64,
//   (image_id i32, point2d i32) * track_len
// Returns number of points parsed, or -1 on malformed input.
// xyz_out: [count*3] f64; rgb_out: [count*3] u8; err_out: [count] f64.
int64_t gsio_parse_points3d(const uint8_t* buf, int64_t n_bytes,
                            double* xyz_out, uint8_t* rgb_out,
                            double* err_out) {
    if (n_bytes < 8) return -1;
    uint64_t count;
    std::memcpy(&count, buf, 8);
    int64_t off = 8;
    for (uint64_t i = 0; i < count; ++i) {
        if (off + 51 > n_bytes) return -1;
        std::memcpy(xyz_out + 3 * i, buf + off + 8, 24);
        std::memcpy(rgb_out + 3 * i, buf + off + 32, 3);
        std::memcpy(err_out + i, buf + off + 35, 8);
        uint64_t track;
        std::memcpy(&track, buf + off + 43, 8);
        // Bound the untrusted variable-length payload BEFORE advancing:
        // a crafted track count must not wrap the offset or run past EOF.
        if (track > static_cast<uint64_t>(n_bytes - off - 51) / 8) return -1;
        off += 51 + 8 * static_cast<int64_t>(track);
    }
    return static_cast<int64_t>(count);
}

// Count points without filling (caller allocates then calls parse).
// Validates the header count against the minimum record size so callers can
// safely allocate count-proportional buffers before parsing.
int64_t gsio_count_points3d(const uint8_t* buf, int64_t n_bytes) {
    if (n_bytes < 8) return -1;
    uint64_t count;
    std::memcpy(&count, buf, 8);
    if (count > static_cast<uint64_t>(n_bytes - 8) / 51) return -1;
    return static_cast<int64_t>(count);
}

// ---------------------------------------------------------------------------
// COLMAP images.bin: header u64 count; per record:
//   image_id i32, qvec f64*4, tvec f64*3, camera_id i32,
//   name char* (NUL-terminated), n2d u64, (x f64, y f64, id i64) * n2d
// Outputs: ids [N] i32, qvec [N*4] f64, tvec [N*3] f64, cam_ids [N] i32,
// names: packed NUL-separated bytes (name_cap total capacity).
int64_t gsio_parse_images(const uint8_t* buf, int64_t n_bytes,
                          int32_t* ids, double* qvec, double* tvec,
                          int32_t* cam_ids, char* names, int64_t name_cap) {
    if (n_bytes < 8) return -1;
    uint64_t count;
    std::memcpy(&count, buf, 8);
    int64_t off = 8;
    int64_t name_off = 0;
    for (uint64_t i = 0; i < count; ++i) {
        if (off + 64 > n_bytes) return -1;
        std::memcpy(ids + i, buf + off, 4);
        std::memcpy(qvec + 4 * i, buf + off + 4, 32);
        std::memcpy(tvec + 3 * i, buf + off + 36, 24);
        std::memcpy(cam_ids + i, buf + off + 60, 4);
        off += 64;
        while (off < n_bytes && buf[off] != 0) {
            if (name_off + 1 >= name_cap) return -1;
            names[name_off++] = static_cast<char>(buf[off++]);
        }
        if (off >= n_bytes) return -1;
        names[name_off++] = '\0';
        ++off;  // skip NUL
        uint64_t n2d;
        if (off + 8 > n_bytes) return -1;
        std::memcpy(&n2d, buf + off, 8);
        // Same untrusted-count discipline as points3d: bound n2d before
        // advancing so the offset stays monotonic and in-range.
        if (n2d > static_cast<uint64_t>(n_bytes - off - 8) / 24) return -1;
        off += 8 + 24 * static_cast<int64_t>(n2d);
    }
    return static_cast<int64_t>(count);
}

// Min image record: 64 fixed + 1 NUL + 8 n2d = 73 bytes.
int64_t gsio_count_images(const uint8_t* buf, int64_t n_bytes) {
    if (n_bytes < 8) return -1;
    uint64_t count;
    std::memcpy(&count, buf, 8);
    if (count > static_cast<uint64_t>(n_bytes - 8) / 73) return -1;
    return static_cast<int64_t>(count);
}

}  // extern "C"
