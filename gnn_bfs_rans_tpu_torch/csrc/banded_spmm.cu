// Banded SpMM: the GCN and GIN neighbour aggregation over the block band.
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded.py::banded_spmm_fwd
// (_spmm_kernel).  Computes, for every receiver row r = t·T + i,
//
//   out[r] = Σ_{k < W} Σ_{j < T} A[t, k, i, j] · x[(t − k0 + k)·T + j],  k0 = W/2
//
// with A the [n_tiles, W, T, T] band plane (the f32 GCN coefficients or the
// bf16 0/1 adjacency) and x [n_pad, F] in f32 or bf16.  Every product is an
// exact f32 product (bf16 values widen exactly), the sum is f32, and the
// result rounds once to x's dtype.  So GCN's f32 coefficients are never
// rounded, in bf16 as in f32: the JAX package's interpret path promotes the
// bf16 features to f32 in the same way.  Window blocks whose sender tile
// lies outside [0, n_tiles) are skipped and never read (build_band leaves
// them zero; the TPU kernel clamps its window onto a duplicate tile and
// relies on those zeros, which a CUDA kernel must not copy: it would read
// outside x).  The backward is this kernel on the transposed band
// (kernels/banded.py::transpose_band).
//
// What bounds it on an H100: the TPU kernel runs W dense T×T products per
// tile on its matrix unit, 2·n_tiles·W·T²·F operations — 2.37 GFLOP at N
// 12,032, F 256, W 3, about 35 µs on the SIMT units in f32 (f32 coefficients
// rule out TF32 and bf16 tensor cores).  The band holds about 5 nonzeros per
// row (59k at that mesh: 47,140 edges plus 12,000 self-loops), 2·nnz·F = 30
// MFLOP, so the work the data needs is bound by bytes: the plane (18.5 MB in
// f32, 9.2 MB in bf16), x and out.  Design: one warp per receiver row reads
// the row's W·T coefficients, 32 at a time with coalesced loads; a ballot
// marks the nonzeros, and for each set bit in ascending window-column order
// the warp broadcasts the coefficient (shuffle) and adds coefficient × x row
// into per-lane f32 accumulators.  Only the nonzero entries' x rows are read,
// and zero coefficients are never multiplied.  A lane covers 4 adjacent
// columns in each of 2 groups (4·lane + 128·g + q) of a 256-column chunk;
// blockIdx.y picks the chunk.  F must be a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;
constexpr int GROUPS = 2;
constexpr int COLS_PER_LANE = 4 * GROUPS;
constexpr int COL_CHUNK = 32 * COLS_PER_LANE;

using band::load4;
using band::store4;
using band::to_f;

template <typename TA, typename TX>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) spmm_kernel(
    const TA* __restrict__ a,   // [n_tiles, W, T, T]
    const TX* __restrict__ x,   // [n_pad, F]
    TX* __restrict__ out,       // [n_pad, F]
    int n_pad, int f, int tile, int window) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= n_pad) return;  // whole warp: no block-wide barrier below
  const int n_tiles = n_pad / tile;
  const int t = row / tile, i = row % tile;
  const int k0 = window / 2;
  const int c_base = blockIdx.y * COL_CHUNK;

  float acc[COLS_PER_LANE];
#pragma unroll
  for (int q = 0; q < COLS_PER_LANE; ++q) acc[q] = 0.f;

  for (int k = 0; k < window; ++k) {
    const int st = t - k0 + k;
    if (st < 0 || st >= n_tiles) continue;  // uniform across the warp
    const TA* arow = a + (((size_t)t * window + k) * tile + i) * tile;
    const TX* xblk = x + (size_t)st * tile * f;
    for (int base = 0; base < tile; base += 32) {
      const int j = base + lane;
      const float v = j < tile ? to_f(arow[j]) : 0.f;
      unsigned bal = __ballot_sync(0xffffffffu, v != 0.f);
      while (bal) {  // the row's nonzeros in ascending column order
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        const float coef = __shfl_sync(0xffffffffu, v, src);
        const TX* xr = xblk + (size_t)(base + src) * f;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          const int c = c_base + 4 * lane + 128 * g;
          if (c < f) {
            float xv[4];
            load4(xr + c, xv);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[4 * g + q] = fmaf(coef, xv[q], acc[4 * g + q]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int c = c_base + 4 * lane + 128 * g;
    if (c < f) store4(out + (size_t)row * f + c, &acc[4 * g]);
  }
}

template <typename TA, typename TX>
int launch(const void* a, const void* x, void* out, int n_pad, int f,
           int tile, int window, cudaStream_t stream) {
  dim3 grid((n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
            (f + COL_CHUNK - 1) / COL_CHUNK);
  spmm_kernel<TA, TX><<<grid, 32 * ROWS_PER_BLOCK, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TX*>(x),
      static_cast<TX*>(out), n_pad, f, tile, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a_dtype, x_dtype: 0 = float32, 1 = bfloat16 (out shares x's).  a is the
// [n_pad/tile, window, tile, tile] band plane, x and out [n_pad, f].
// Returns the CUDA error code of the launch (0 on success).
int banded_spmm_launch(const void* a, const void* x, void* out, int n_pad,
                       int f, int tile, int window, int a_dtype, int x_dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (a_dtype == 0 && x_dtype == 0)
    return launch<float, float>(a, x, out, n_pad, f, tile, window, s);
  if (a_dtype == 0 && x_dtype == 1)
    return launch<float, bf16>(a, x, out, n_pad, f, tile, window, s);
  if (a_dtype == 1 && x_dtype == 0)
    return launch<bf16, float>(a, x, out, n_pad, f, tile, window, s);
  if (a_dtype == 1 && x_dtype == 1)
    return launch<bf16, bf16>(a, x, out, n_pad, f, tile, window, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
