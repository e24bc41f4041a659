// Fold of window partials into sender rows.
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded_bwd.py::
// fold_partials (_fold_kernel).  The Transformer backward
// (banded_transformer_bwd.cu) writes, per receiver tile t and window block
// k, the partial sum part[t, k] [sub, F] of its receivers' contributions
// to the senders of that block: sender sub-tile t·r + k − k0 (r = T / sub
// blocks per tile, k0 = (W_sub − r) / 2).  Inverting, output tile u's
// sub-row block m collects
//
//   out[u·T + m·sub + i] = Σ_{k : (k − k0) mod r = m} part[u − ⌊(k − k0)/r⌋, k, i]
//
// over the W_sub / r blocks whose source tile lies in [0, n_tiles); blocks
// outside it are dropped, not clamped (combine_partials' zero padding).
// The sum runs in f32 in ascending k, as combine_partials adds its slices,
// and rounds once to the output type.
//
// What bounds it on an H100: bytes, with no reuse: the partials are read
// once (n_tiles·W_sub·sub·F elements; 49.3 MB per array in bf16 at N
// 12,032, Wcols 256, H·C 1,024) and the rows written once (24.6 MB), 22 µs
// at 3.35 TB/s.  One thread per output row and 4 adjacent columns: each of
// its W_sub / r loads is one 8-byte (bf16) or 16-byte (f32) access, and
// neighbouring threads read neighbouring addresses.  The output may be a
// column block of a wider buffer (row stride ld_out): the Transformer's
// projection backward folds dk and dv into its [N, 3·H·C] cotangent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"

namespace {

using band::load4;
using band::store4;

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(256) fold_kernel(
    const TI* __restrict__ part,  // [n_tiles, w_sub, sub, feat]
    TO* __restrict__ out, int ld_out, int n_tiles, int w_sub, int sub,
    int r, int k0, int feat) {
  const int f4 = feat / 4;
  const int tile = r * sub;
  const long long total = (long long)n_tiles * tile * f4;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(e / f4);
    const int c = (int)(e % f4) * 4;
    const int u = row / tile, rem = row % tile;
    const int m = rem / sub, i = rem % sub;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < w_sub; ++k) {
      const int d = k - k0;
      const int sft = floor_div(d, r);
      if (d - sft * r != m) continue;
      const int src = u - sft;
      if (src < 0 || src >= n_tiles) continue;
      float v[4];
      load4(part + (((size_t)src * w_sub + k) * sub + i) * feat + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += v[j];
    }
    store4(out + (size_t)row * ld_out + c, acc);
  }
}

template <typename TI, typename TO>
int launch(const void* part, void* out, int ld_out, int n_tiles, int w_sub,
           int sub, int r, int k0, int feat, cudaStream_t s) {
  const long long total = (long long)n_tiles * r * sub * (feat / 4);
  const long long blocks = (total + 255) / 256;
  fold_kernel<TI, TO><<<(int)(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(
      static_cast<const TI*>(part), static_cast<TO*>(out), ld_out, n_tiles,
      w_sub, sub, r, k0, feat);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part [n_tiles, w_sub, sub, feat] in in_dtype, out [n_tiles·r·sub, feat]
// (row stride ld_out) in out_dtype; dtypes 0 = float32, 1 = bfloat16.  feat
// and ld_out are multiples of 4, both bases 8-byte (bf16) or 16-byte (f32)
// aligned.  Returns the CUDA error code of the launch (0 on success).
int fold_partials_launch(const void* part, void* out, int ld_out, int n_tiles,
                         int w_sub, int sub, int r, int k0, int feat,
                         int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(part, out, ld_out, n_tiles, w_sub, sub, r, k0,
                                feat, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(part, out, ld_out, n_tiles, w_sub, sub,
                                        r, k0, feat, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(part, out, ld_out, n_tiles, w_sub, sub,
                                        r, k0, feat, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(part, out, ld_out, n_tiles,
                                                w_sub, sub, r, k0, feat, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
