// PyTorch binding of the hand-written kernels (scan_kernels.cu,
// render_kernel.cu, blend_kernels.cu, encode_kernel.cu). The only source
// that includes torch/extension.h; the kernels themselves have a plain C
// interface so nvcc never compiles PyTorch's headers. The Python wrappers
// in raster/scan_kernel.py and
// raster/tile_kernel.py check device, dtype, shape and contiguity and
// allocate every output; this file passes pointers and PyTorch's current
// stream and raises when a launch is refused.

#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

extern "C" {
long long gsplat_expand_scan_state_words(long long k);
int gsplat_expand_scan(const int* marks, const int* base_in, long long k,
                       void* state, int* pack_out, int* base_out,
                       int* rank_out, cudaStream_t stream);
int gsplat_merge_expand(const int* starts, const int* pack, int p, int k,
                        int* pack_out, int* base_out, int* rank_out,
                        cudaStream_t stream);
long long gsplat_render_scratch_floats(int num_tiles, int n_pix, int tile_x,
                                       int tile_y);
int gsplat_render_forward(const void* feat, long long k_slots,
                          const int* chunk_meta, int n_chunks,
                          const float* bg, void* out, void* scratch,
                          int num_tiles, int n_pix, int tile_x, int tile_y,
                          int grid_x, int chunk, cudaStream_t stream);
int gsplat_blend_forward(const float* feat, long long k_slots,
                         const int* chunk_meta, int n_chunks, float* ct,
                         int* used, int num_tiles, int n_pix, int tile_x,
                         int tile_y, int grid_x, int chunk,
                         cudaStream_t stream);
int gsplat_blend_backward(const float* feat, long long k_slots,
                          const int* chunk_meta, int n_chunks,
                          const float* dpack, float* dfeat, int num_tiles,
                          int n_pix, int tile_x, int tile_y, int grid_x,
                          int chunk, cudaStream_t stream);
long long gsplat_multi_cumsum_state_words(int n, long long k);
int gsplat_multi_cumsum(const float* x, int n, long long k, void* state,
                        float* out, cudaStream_t stream);
long long gsplat_multi_cummax_state_words(int n, long long k);
unsigned long long gsplat_multi_cummax_epoch_limit();
int gsplat_multi_cummax(const int* x, int n, long long k, void* state,
                        int* out, cudaStream_t stream);
int gsplat_encode_rgb8(const void* img, long long n, void* out,
                       cudaStream_t stream);
}

namespace {

cudaStream_t stream() { return c10::cuda::getCurrentCUDAStream(); }

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, ": CUDA launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

int64_t expand_scan_state_words(int64_t k) {
  return gsplat_expand_scan_state_words(k);
}

void expand_scan(torch::Tensor marks, torch::Tensor base_in,
                 torch::Tensor state, torch::Tensor pack, torch::Tensor base,
                 torch::Tensor rank) {
  check(gsplat_expand_scan(marks.data_ptr<int>(), base_in.data_ptr<int>(),
                           marks.numel(), state.data_ptr<int64_t>(),
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

int64_t render_scratch_floats(int64_t num_tiles, int64_t n_pix,
                              int64_t tile_x, int64_t tile_y) {
  return gsplat_render_scratch_floats(
      static_cast<int>(num_tiles), static_cast<int>(n_pix),
      static_cast<int>(tile_x), static_cast<int>(tile_y));
}

// scratch: render_scratch_floats(...) float32 (an empty tensor when 0)
void render_forward(torch::Tensor feat, torch::Tensor chunk_meta,
                    torch::Tensor bg, torch::Tensor out,
                    torch::Tensor scratch, int64_t n_pix, int64_t tile_x,
                    int64_t tile_y, int64_t grid_x, int64_t chunk) {
  check(gsplat_render_forward(
            feat.data_ptr(), feat.size(1), chunk_meta.data_ptr<int>(),
            static_cast<int>(chunk_meta.numel()), bg.data_ptr<float>(),
            out.data_ptr(),
            scratch.numel() ? scratch.data_ptr<float>() : nullptr,
            static_cast<int>(out.size(0)),
            static_cast<int>(n_pix), static_cast<int>(tile_x),
            static_cast<int>(tile_y), static_cast<int>(grid_x),
            static_cast<int>(chunk), stream()),
        "render_forward");
}

void blend_forward(torch::Tensor feat, torch::Tensor chunk_meta,
                   torch::Tensor ct, torch::Tensor used, int64_t n_pix,
                   int64_t tile_x, int64_t tile_y, int64_t grid_x,
                   int64_t chunk) {
  check(gsplat_blend_forward(
            feat.data_ptr<float>(), feat.size(1),
            chunk_meta.data_ptr<int>(),
            static_cast<int>(chunk_meta.numel()), ct.data_ptr<float>(),
            used.data_ptr<int>(), static_cast<int>(ct.size(0)),
            static_cast<int>(n_pix), static_cast<int>(tile_x),
            static_cast<int>(tile_y), static_cast<int>(grid_x),
            static_cast<int>(chunk), stream()),
        "blend_forward");
}

void blend_backward(torch::Tensor feat, torch::Tensor chunk_meta,
                    torch::Tensor dpack, torch::Tensor dfeat, int64_t n_pix,
                    int64_t tile_x, int64_t tile_y, int64_t grid_x,
                    int64_t chunk) {
  check(gsplat_blend_backward(
            feat.data_ptr<float>(), feat.size(1),
            chunk_meta.data_ptr<int>(),
            static_cast<int>(chunk_meta.numel()), dpack.data_ptr<float>(),
            dfeat.data_ptr<float>(), static_cast<int>(dpack.size(0)),
            static_cast<int>(n_pix), static_cast<int>(tile_x),
            static_cast<int>(tile_y), static_cast<int>(grid_x),
            static_cast<int>(chunk), stream()),
        "blend_backward");
}

int64_t multi_cumsum_state_words(int64_t n, int64_t k) {
  return gsplat_multi_cumsum_state_words(static_cast<int>(n), k);
}

void multi_cumsum(torch::Tensor x, torch::Tensor state, torch::Tensor out) {
  check(gsplat_multi_cumsum(x.data_ptr<float>(),
                            static_cast<int>(x.size(0)), x.size(1),
                            state.data_ptr<int64_t>(), out.data_ptr<float>(),
                            stream()),
        "multi_cumsum");
}

int64_t multi_cummax_state_words(int64_t n, int64_t k) {
  return gsplat_multi_cummax_state_words(static_cast<int>(n), k);
}

int64_t multi_cummax_epoch_limit() {
  return static_cast<int64_t>(gsplat_multi_cummax_epoch_limit());
}

void multi_cummax(torch::Tensor x, torch::Tensor state, torch::Tensor out) {
  check(gsplat_multi_cummax(x.data_ptr<int>(), static_cast<int>(x.size(0)),
                            x.size(1), state.data_ptr<int64_t>(),
                            out.data_ptr<int>(), stream()),
        "multi_cummax");
}

// img: [3, H, W] bf16, out: [H, W, 3] uint8, both contiguous on the card;
// checked here too, since a host pointer would fault the kernel
void encode_rgb8(torch::Tensor img, torch::Tensor out) {
  TORCH_CHECK(img.is_cuda() && out.is_cuda() &&
                  img.device() == out.device(),
              "encode_rgb8: tensors on one CUDA device");
  TORCH_CHECK(img.scalar_type() == torch::kBFloat16 &&
                  out.scalar_type() == torch::kUInt8,
              "encode_rgb8: bf16 in, uint8 out");
  TORCH_CHECK(img.is_contiguous() && out.is_contiguous() &&
                  img.dim() == 3 && img.size(0) == 3 &&
                  out.numel() == img.numel(),
              "encode_rgb8: contiguous [3, H, W] in, [H, W, 3] out");
  check(gsplat_encode_rgb8(img.data_ptr(), img.numel() / 3, out.data_ptr(),
                           stream()),
        "encode_rgb8");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("expand_scan_state_words", &expand_scan_state_words);
  m.def("expand_scan", &expand_scan);
  m.def("merge_expand", &merge_expand);
  m.def("render_scratch_floats", &render_scratch_floats);
  m.def("render_forward", &render_forward);
  m.def("blend_forward", &blend_forward);
  m.def("blend_backward", &blend_backward);
  m.def("multi_cumsum_state_words", &multi_cumsum_state_words);
  m.def("multi_cumsum", &multi_cumsum);
  m.def("multi_cummax_state_words", &multi_cummax_state_words);
  m.def("multi_cummax_epoch_limit", &multi_cummax_epoch_limit);
  m.def("multi_cummax", &multi_cummax);
  m.def("encode_rgb8", &encode_rgb8);
}
