// PyTorch binding of the hand-written kernels (scan_kernels.cu,
// render_kernel.cu). The only source that includes torch/extension.h; the
// kernels themselves have a plain C interface so nvcc never compiles
// PyTorch's headers. The Python wrappers in raster/scan_kernel.py and
// raster/tile_kernel.py check device, dtype, shape and contiguity and
// allocate every output; this file passes pointers and PyTorch's current
// stream and raises when a launch is refused.

#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

extern "C" {
int gsplat_expand_scan_tiles(long long k);
int gsplat_expand_scan(const int* marks, const int* base_in, long long k,
                       int* agg, int* pack_out, int* base_out, int* rank_out,
                       cudaStream_t stream);
int gsplat_merge_expand(const int* starts, const int* pack, int p, int k,
                        int* pack_out, int* base_out, int* rank_out,
                        cudaStream_t stream);
int gsplat_render_forward(const void* feat, long long k_slots,
                          const int* chunk_meta, int n_chunks,
                          const float* bg, void* out, int num_tiles,
                          int n_pix, int tile_x, int tile_y, int grid_x,
                          int chunk, cudaStream_t stream);
}

namespace {

cudaStream_t stream() { return c10::cuda::getCurrentCUDAStream(); }

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": CUDA launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

int64_t expand_scan_tiles(int64_t k) { return gsplat_expand_scan_tiles(k); }

void expand_scan(torch::Tensor marks, torch::Tensor base_in,
                 torch::Tensor agg, torch::Tensor pack, torch::Tensor base,
                 torch::Tensor rank) {
  check(gsplat_expand_scan(marks.data_ptr<int>(), base_in.data_ptr<int>(),
                           marks.numel(), agg.data_ptr<int>(),
                           pack.data_ptr<int>(), base.data_ptr<int>(),
                           rank.data_ptr<int>(), stream()),
        "expand_scan");
}

void merge_expand(torch::Tensor starts, torch::Tensor pack,
                  torch::Tensor pack_out, torch::Tensor base_out,
                  torch::Tensor rank_out) {
  check(gsplat_merge_expand(starts.data_ptr<int>(), pack.data_ptr<int>(),
                            static_cast<int>(starts.numel()),
                            static_cast<int>(pack_out.numel()),
                            pack_out.data_ptr<int>(),
                            base_out.data_ptr<int>(),
                            rank_out.data_ptr<int>(), stream()),
        "merge_expand");
}

void render_forward(torch::Tensor feat, torch::Tensor chunk_meta,
                    torch::Tensor bg, torch::Tensor out, int64_t n_pix,
                    int64_t tile_x, int64_t tile_y, int64_t grid_x,
                    int64_t chunk) {
  check(gsplat_render_forward(
            feat.data_ptr(), feat.size(1), chunk_meta.data_ptr<int>(),
            static_cast<int>(chunk_meta.numel()), bg.data_ptr<float>(),
            out.data_ptr(), static_cast<int>(out.size(0)),
            static_cast<int>(n_pix), static_cast<int>(tile_x),
            static_cast<int>(tile_y), static_cast<int>(grid_x),
            static_cast<int>(chunk), stream()),
        "render_forward");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("expand_scan_tiles", &expand_scan_tiles);
  m.def("expand_scan", &expand_scan);
  m.def("merge_expand", &merge_expand);
  m.def("render_forward", &render_forward);
}
