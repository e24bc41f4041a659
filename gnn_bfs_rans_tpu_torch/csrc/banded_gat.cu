// Banded GAT forward: fused-projection head mean, and the attention alone
// on a given z in its head-mean and concat forms.
//
// Replaces two TPU kernels of gnn_bfs_rans_tpu/kernels/banded.py:
// banded_gat_mean_fused_fwd (_gat_kernel with fuse_proj=True,
// mean_heads=True, dropout and emit_z; no emit_stats), entry
// banded_gat_mean_fused_launch, and banded_gat_fwd (row 4, no emit_stats)
// with mean_heads=True (the unfused head-mean training path) or False (the
// concat GAT, GATConv(concat=True)), entry banded_gat_launch, which runs the
// attention phase below on the caller's z.  Computes, for every receiver
// row i of tile t = i / T and every head h,
//
//   z      = x · W                          (f32 accumulate, rounded to x's dtype)
//   l[i,j] = LeakyReLU(α_dst[i,h] + α_src[s_j,h]),  s_j = t·T − (Wcols−T)/2 + j,
//            over the window columns j whose int8 band mask is 1
//   e      = exp(l − max_j l),   inv = 1 / max(Σ_j e, 1e-16)
//   ẽ_j    = e_j · keep_j / (1 − rate)   (training: attention dropout)
//   o_h[i] = inv_h · Σ_j round(ẽ_j) · z[s_j, h·C:(h+1)·C]   (f32)
//   out[i] = (Σ_h o_h[i]) / H            head mean: [N, C]
//   out[i, h·C:(h+1)·C] = o_h[i]         concat:    [N, H·C]
//
// each rounded once to the output dtype (concat: every head on its own,
// as the TPU kernel casts the concatenated f32 heads), with round() the
// cast of the probability to bf16 when x is bf16 (the TPU kernel's
// _mm_cast) and the identity in f32.  Dropout acts on the
// unnormalized e after the denominator is summed, as the TPU kernel's does;
// keep_j is the dropout.cuh hash of (seed + t, (h·T + i mod T)·Wcols + j),
// the TPU kernel's interpret-mode stream over tile t's [H·T, Wcols] plane.
// Sender rows outside [0, n_pad) are absent: never read (their mask
// entries are 0 anyway).  z stays in device memory: the training form hands
// it to the backward (the TPU kernel's emit_z residual) at no extra cost.
//
// What bounds it on an H100: the projection, 2·N·F·H·C operations (6.3
// GFLOP per layer at N 12,032, F 256, H 4, C 256), is the only dense work.
// The attention is a sparse product: the band mask holds ~5 entries per row
// of 256-640 columns, so the work this data needs is 2·nnz·H·C operations.
// The TPU kernel computes the whole [T, Wcols] plane because its matrix unit
// has no gather; here one warp per receiver row compacts the row's mask to
// its nonzero columns (a ballot), computes only those logits, and gathers
// only those z rows, so the dense plane is never formed.  The projection is
// a shared-memory-tiled GEMM (gemm.cuh): on the tensor cores (warp mma, f32
// accumulate) in bf16, and in true f32 FMA on the SIMT units in f32 (the f32
// path must not use TF32, matching the TPU kernel's Precision.HIGHEST).
// Unlike the TPU kernel, z makes one round trip through device memory
// (N·H·C·dtype bytes: 24.6 MB per layer at the flagship shape in bf16);
// keeping z on chip, and wgmma/TMA for the projection, are later work.
// Row 4 has no projection: it reads z, the mask, α and writes out (34.3 MB
// per layer at the flagship shape in bf16 for the head mean, 52.7 MB for
// concat, whose output is H times wider), so it is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"
#include "gemm.cuh"

namespace {

// ----------------------------------------------------------------- attention
// One warp per receiver row, 8 rows per block; blockIdx.y picks a chunk of
// 256 output columns.  A lane covers 4 adjacent columns in each of 2 groups
// (4·lane + 128·g + q), read and written as one 8-byte (bf16) or 16-byte
// (f32) access; C must be a multiple of 4.  Per warp, shared memory holds
// the row's compacted sender list and its probabilities.
constexpr int ROWS_PER_BLOCK = 8;
constexpr int GROUPS = 2;
constexpr int COLS_PER_LANE = 4 * GROUPS;
constexpr int COL_CHUNK = 32 * COLS_PER_LANE;

using band::load4;
using band::mm_round;
using band::store4;
using band::warp_max;
using band::warp_sum;

// DROP: training form (seed non-null); the eval form carries no hash code.
// CONCAT: each head's output written to its own C columns (row 4's concat
// form); else the head mean.
template <typename T, bool DROP, bool CONCAT>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) gat_attention_kernel(
    const int8_t* __restrict__ mask,    // [n_tiles, T, Wcols]
    const float* __restrict__ alphas,   // [n_pad, 2H]: src | dst
    const T* __restrict__ z,            // [n_pad, H·C]
    T* __restrict__ out,                // [n_pad, C], or [n_pad, H·C] (CONCAT)
    int n_pad, int heads, int C, int tile, int wcols, float slope,
    const int* __restrict__ seed, uint32_t thresh, float inv_keep) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= n_pad) return;  // whole warp: no block-wide barrier below
  int* idx = reinterpret_cast<int*>(smem) + warp * 2 * wcols;
  float* pw = reinterpret_cast<float*>(idx + wcols);

  const int t = row / tile;
  const int s0 = t * tile - (wcols - tile) / 2;
  const int8_t* mrow = mask + (size_t)row * wcols;  // [t, row % T] row
  // dropout stream of receiver tile t over its [H·T, Wcols] plane
  const uint32_t sv = DROP ? (uint32_t)seed[0] + (uint32_t)t : 0u;

  // compact the mask row to its in-range nonzero sender rows (in order)
  int cnt = 0;
  for (int base = 0; base < wcols; base += 32) {
    const int j = base + lane;
    const int s = s0 + j;
    const bool on = j < wcols && s >= 0 && s < n_pad && mrow[j] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (on) idx[cnt + __popc(bal & ((1u << lane) - 1u))] = s;
    cnt += __popc(bal);
  }
  __syncwarp();

  const int hc = heads * C;
  const int two_h = 2 * heads;
  const int c_base = blockIdx.y * COL_CHUNK;
  float total[COLS_PER_LANE];
#pragma unroll
  for (int j = 0; j < COLS_PER_LANE; ++j) total[j] = 0.f;

  for (int h = 0; h < heads; ++h) {
    const float ad = alphas[(size_t)row * two_h + heads + h];
    float mx = -CUDART_INF_F;
    for (int k = lane; k < cnt; k += 32) {
      float a = ad + alphas[(size_t)idx[k] * two_h + h];
      a = a >= 0.f ? a : slope * a;
      pw[k] = a;
      mx = fmaxf(mx, a);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    const uint32_t plane_row = (uint32_t)(h * tile + row % tile) * (uint32_t)wcols;
    for (int k = lane; k < cnt; k += 32) {
      const float e = expf(pw[k] - mx);
      sum += e;  // the denominator is fixed before dropout
      float p = e;
      if (DROP)
        p = dropout_hash(sv, plane_row + (uint32_t)(idx[k] - s0)) >= thresh
                ? e * inv_keep : 0.f;
      pw[k] = mm_round<T>(p);
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.f / fmaxf(sum, 1e-16f);

    float acc[COLS_PER_LANE];
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) acc[j] = 0.f;
    for (int k = 0; k < cnt; ++k) {
      const float p = pw[k];
      const T* zr = z + (size_t)idx[k] * hc + (size_t)h * C;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int c = c_base + 4 * lane + 128 * g;
        if (c < C) {
          float v[4];
          load4(zr + c, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[4 * g + q] = fmaf(p, v[q], acc[4 * g + q]);
        }
      }
    }
    if (CONCAT) {
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int c = c_base + 4 * lane + 128 * g;
        if (c < C) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = acc[4 * g + q] * inv;
          store4(out + (size_t)row * hc + (size_t)h * C + c, v);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) total[j] += acc[j] * inv;
    }
    __syncwarp();  // pw is rewritten by the next head
  }
  if (CONCAT) return;

  const float inv_heads = 1.f / (float)heads;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int c = c_base + 4 * lane + 128 * g;
    if (c < C) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = total[4 * g + q] * inv_heads;
      store4(out + (size_t)row * C + c, v);
    }
  }
}

template <typename T>
int attention(const int8_t* mask, const float* alphas, const void* z,
              void* out, int n_pad, int heads, int c, int tile, int wcols,
              float slope, bool concat, const int* seed, uint32_t thresh,
              float inv_keep, cudaStream_t stream) {
  dim3 agrid((n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
             (c + COL_CHUNK - 1) / COL_CHUNK);
  const size_t smem = (size_t)ROWS_PER_BLOCK * wcols * (sizeof(int) + sizeof(float));
  auto kernel = concat ? (seed != nullptr ? gat_attention_kernel<T, true, true>
                                          : gat_attention_kernel<T, false, true>)
                       : (seed != nullptr ? gat_attention_kernel<T, true, false>
                                          : gat_attention_kernel<T, false, false>);
  kernel<<<agrid, 32 * ROWS_PER_BLOCK, smem, stream>>>(
      mask, alphas, static_cast<const T*>(z), static_cast<T*>(out), n_pad,
      heads, c, tile, wcols, slope, seed, thresh, inv_keep);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const int8_t* mask, const void* w, const float* alphas,
           const void* x, void* z, void* out, int n_pad, int f, int heads,
           int c, int tile, int wcols, float slope, const int* seed,
           uint32_t thresh, float inv_keep, cudaStream_t stream) {
  // z = x·W: A = x [n_pad, F] K-contiguous, B = W [F, H·C] N-contiguous
  cudaError_t err = gemm::matmul(
      static_cast<const T*>(x), f, static_cast<const T*>(w), heads * c,
      static_cast<T*>(z), heads * c, n_pad, heads * c, f, stream);
  if (err != cudaSuccess) return (int)err;
  return attention<T>(mask, alphas, z, out, n_pad, heads, c, tile, wcols,
                      slope, false, seed, thresh, inv_keep, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, z and out share it).  z is the
// caller-allocated [n_pad, heads·c] projection, left in place for the
// backward.  seed: device pointer to one int32, or null for no dropout;
// an attention entry is kept when its hash is >= thresh and then scaled by
// inv_keep.  Returns the CUDA error code of the launches (0 on success).
int banded_gat_mean_fused_launch(const int8_t* mask, const void* w,
                                 const float* alphas, const void* x, void* z,
                                 void* out, int n_pad, int f, int heads, int c,
                                 int tile, int wcols, float slope, int dtype,
                                 const int* seed, unsigned int thresh,
                                 float inv_keep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(mask, w, alphas, x, z, out, n_pad, f, heads, c, tile,
                         wcols, slope, seed, thresh, inv_keep, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mask, w, alphas, x, z, out, n_pad, f, heads,
                                 c, tile, wcols, slope, seed, thresh, inv_keep,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// Row 4, the attention alone on a given z [n_pad, heads·c]: the head mean
// [n_pad, c] (concat = 0) or every head's output [n_pad, heads·c]
// (concat = 1); dtype, seed, thresh and inv_keep as above.
int banded_gat_launch(const int8_t* mask, const float* alphas, const void* z,
                      void* out, int n_pad, int heads, int c, int tile,
                      int wcols, float slope, int concat, int dtype,
                      const int* seed, unsigned int thresh, float inv_keep,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attention<float>(mask, alphas, z, out, n_pad, heads, c, tile,
                            wcols, slope, concat != 0, seed, thresh, inv_keep,
                            s);
  if (dtype == 1)
    return attention<__nv_bfloat16>(mask, alphas, z, out, n_pad, heads, c,
                                    tile, wcols, slope, concat != 0, seed,
                                    thresh, inv_keep, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
