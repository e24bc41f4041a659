// Banded GAT backward (head-mean or per-head cotangent, α packed src | dst).
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded_bwd.py::
// banded_gat_bwd (_gat_bwd_kernel with mxu_das=True, raw_dz_partials=True)
// in both its cotangent forms: mean_expand=True, the cotangent g of the
// head-mean output [N, C] (kernel 1's op and row 4's head-mean op), and
// mean_expand=False, the per-head cotangent [N, H·C] of the concat output
// (row 4's concat op, the JAX package's _gat_vjp_bwd).  Given the forward's
// inputs, its z and g, it returns
//
//   dz [N, H·C] (z's dtype)  and  dα [N, 2H] f32 (src | dst),
//
// with, for receiver i, head h and each sender j of i's window (band mask 1),
//   gout_i = g_i / H (head mean)  or  g_i[h·C:(h+1)·C] (per head),
//   dp_ij  = round(gout_i) · z_j,h   (keep-masked, ×1/(1−rate))
//   rs_i   = inv_i · Σ_j e_ij·dp_ij,   dpre_ij = e_ij·(dp_ij − rs_i)·inv_i·LeakyReLU'(pre_ij)
//   dα_dst[i,h] = Σ_j dpre_ij,         dα_src[j,h] = Σ_i round(dpre_ij)
//   dz[j, h·C:(h+1)·C] = Σ_i round(ẽ_ij) · round(gout_i · inv_i)
// where e, inv, ẽ are the forward's (recomputed, dropout replayed from the
// same hash) and round() is the TPU kernels' bf16 rounding point (_mm_cast)
// in bf16, the identity in f32.  The two forms differ only in where head h
// reads its cotangent row (row stride C or H·C, offset 0 or h·C) and its
// factor (1/H or 1).
//
// Receiver-indexed gradients are local to a receiver row; sender-indexed
// ones (dz, dα_src) collect from every receiver whose window holds the
// sender.  The TPU kernel writes per-window partials [n_tiles, W_sub, sub,
// H·C] (in z's dtype) that fold_project_bwd folds.  Here two passes give
// deterministic sums with no atomics and no partials:
//
//  1. gat_bwd_rows_kernel — one warp per receiver row: compacts the mask
//     row (warp ballot, as the forward), recomputes the softmax, forms dp
//     by warp dot products, writes dα_dst and the row statistics
//     (max, 1/denominator, rs) per head: a small [N, 3H] f32 array;
//  2. gat_bwd_cols_kernel — one warp per sender row s: walks the mask
//     COLUMN of s in every receiver tile whose window holds s (ballots over
//     the tile's rows), so it needs no symmetric adjacency, and sums that
//     sender's dz row and dα_src in f32 registers in a fixed order, then
//     rounds dz once.
//
// dz therefore rounds once (f32 sums, one cast) where the TPU kernel rounds
// each window partial to bf16 before an f32 fold: the two differ by a few
// bf16 ulps in bf16 and by f32 summation order in f32.  Row 6
// (fold_project_bwd.cu) then takes dz rows directly.
//
// What bounds it on an H100: memory.  It must read z (24.6 MB at N 12,032,
// H·C 1,024, bf16), g, α and the mask and write dz (24.6 MB): ~59 MB, 18 µs
// at 3.35 TB/s (per head: g is as wide as z, ~78 MB, 23 µs); its
// arithmetic is the sparse products, 4·nnz·H·C operations.  The sender
// pass re-reads the g rows of each sender's receivers (from L2: each row
// is shared by the ~5 senders of a receiver).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"

namespace {

using band::from_f;
using band::mm_round;
using band::to_f;
using band::warp_max;
using band::warp_sum;

constexpr int WARPS = 4;  // rows per block in both passes

// round(gout_i) · z_j,h over C, reduced across the warp (every lane gets
// it); grow is head h's cotangent row, scaled by inv_heads (1/H or 1)
template <typename T>
__device__ __forceinline__ float dot_gz(const T* __restrict__ grow,
                                        const T* __restrict__ zrow, int C,
                                        float inv_heads, int lane) {
  float part = 0.f;
  for (int c = lane; c < C; c += 32)
    part = fmaf(mm_round<T>(to_f(grow[c]) * inv_heads), to_f(zrow[c]), part);
  return warp_sum(part);
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS) gat_bwd_rows_kernel(
    const int8_t* __restrict__ mask, const float* __restrict__ alphas,
    const T* __restrict__ z, const T* __restrict__ g,
    float* __restrict__ stats,   // [n_pad, 3H]: max | 1/denominator | rs
    float* __restrict__ dalpha,  // [n_pad, 2H]: this pass writes the dst half
    int n_pad, int heads, int C, int tile, int wcols, float slope,
    int g_ld, int g_head, float inv_heads, Drop drop) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= n_pad) return;  // whole warp: no block-wide barrier below
  int* idx = reinterpret_cast<int*>(smem) + warp * 4 * wcols;
  float* pre = reinterpret_cast<float*>(idx + wcols);
  float* ev = pre + wcols;
  float* dp = ev + wcols;

  const int t = row / tile;
  const int s0 = t * tile - (wcols - tile) / 2;
  const int8_t* mrow = mask + (size_t)row * wcols;
  const uint32_t sv = drop.seed != nullptr ? (uint32_t)drop.seed[0] + (uint32_t)t : 0u;

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

  const int hc = heads * C, two_h = 2 * heads;
  for (int h = 0; h < heads; ++h) {
    const T* grow = g + (size_t)row * g_ld + (size_t)h * g_head;
    const float ad = alphas[(size_t)row * two_h + heads + h];
    float mx = -CUDART_INF_F;
    for (int k = lane; k < cnt; k += 32) {
      const float p = ad + alphas[(size_t)idx[k] * two_h + h];
      pre[k] = p;
      mx = fmaxf(mx, p >= 0.f ? p : slope * p);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const float p = pre[k];
      const float e = expf((p >= 0.f ? p : slope * p) - mx);
      ev[k] = e;
      sum += e;
    }
    const float inv = 1.f / fmaxf(warp_sum(sum), 1e-16f);
    for (int k = 0; k < cnt; ++k) {
      const float d = dot_gz(grow, z + (size_t)idx[k] * hc + (size_t)h * C, C,
                             inv_heads, lane);
      if (lane == 0) dp[k] = d;
    }
    __syncwarp();
    const uint32_t plane_row = (uint32_t)(h * tile + row % tile) * (uint32_t)wcols;
    float s1 = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      float d = dp[k];
      if (drop.seed != nullptr) {
        d = dropout_hash(sv, plane_row + (uint32_t)(idx[k] - s0)) >= drop.thresh
                ? d * drop.inv_keep : 0.f;
        dp[k] = d;
      }
      s1 += ev[k] * d;
    }
    const float rs = warp_sum(s1) * inv;
    float s2 = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const float dl = ev[k] * ((dp[k] - rs) * inv);
      s2 += dl * (pre[k] >= 0.f ? 1.f : slope);
    }
    const float dad = warp_sum(s2);
    if (lane == 0) {
      float* st = stats + (size_t)row * 3 * heads;
      st[h] = mx;
      st[heads + h] = inv;
      st[2 * heads + h] = rs;
      dalpha[(size_t)row * two_h + heads + h] = dad;
    }
    __syncwarp();  // pre, ev and dp are rewritten by the next head
  }
}

// dz and dα_src of one sender row per warp.  Its receivers: rows r of the
// tiles t whose window [t·T − pad, t·T − pad + Wcols) holds s, with
// mask[r, s + pad − t·T] = 1, listed in (t, r) order.  At most
// ceil(Wcols / T)·T ≤ Wcols + T of them.
template <typename T>
__global__ void __launch_bounds__(32 * WARPS) gat_bwd_cols_kernel(
    const int8_t* __restrict__ mask, const float* __restrict__ alphas,
    const T* __restrict__ z, const T* __restrict__ g,
    const float* __restrict__ stats, T* __restrict__ dz,
    float* __restrict__ dalpha,  // this pass writes the src half
    int n_pad, int heads, int C, int tile, int wcols, float slope,
    int g_ld, int g_head, float inv_heads, Drop drop) {
  extern __shared__ unsigned char smem[];
  const int cap = wcols + tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * WARPS + warp;
  if (s >= n_pad) return;
  int* recv = reinterpret_cast<int*>(smem) + warp * 3 * cap;
  float* dpk = reinterpret_cast<float*>(recv + cap);
  float* coef = dpk + cap;

  const int pad = (wcols - tile) / 2;
  const int n_tiles = n_pad / tile;
  const int t_hi = min((s + pad) / tile, n_tiles - 1);
  const int t_lo = max(0, (s + pad - wcols) / tile);
  int cnt = 0;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int w = s + pad - t * tile;
    if (w < 0 || w >= wcols) continue;
    const int8_t* mcol = mask + (size_t)t * tile * wcols + w;
    for (int base = 0; base < tile; base += 32) {
      const int i = base + lane;
      const bool on = i < tile && mcol[(size_t)i * wcols] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) recv[cnt + __popc(bal & ((1u << lane) - 1u))] = t * tile + i;
      cnt += __popc(bal);
    }
  }
  __syncwarp();

  const int hc = heads * C, two_h = 2 * heads;
  for (int h = 0; h < heads; ++h) {
    const T* zrow = z + (size_t)s * hc + (size_t)h * C;
    const T* gh = g + (size_t)h * g_head;  // head h's cotangent columns
    for (int k = 0; k < cnt; ++k) {
      const float d = dot_gz(gh + (size_t)recv[k] * g_ld, zrow, C, inv_heads,
                             lane);
      if (lane == 0) dpk[k] = d;
    }
    __syncwarp();
    const float as = alphas[(size_t)s * two_h + h];
    float das = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const int r = recv[k];
      const int t = r / tile;
      const float* st = stats + (size_t)r * 3 * heads;
      const float p = alphas[(size_t)r * two_h + heads + h] + as;
      const float e = expf((p >= 0.f ? p : slope * p) - st[h]);
      const float inv = st[heads + h];
      float ed = e, d = dpk[k];
      if (drop.seed != nullptr) {
        const uint32_t flat = (uint32_t)(h * tile + r % tile) * (uint32_t)wcols
                              + (uint32_t)(s + pad - t * tile);
        const bool keep = dropout_hash((uint32_t)drop.seed[0] + (uint32_t)t, flat)
                          >= drop.thresh;
        ed = keep ? e * drop.inv_keep : 0.f;
        d = keep ? d * drop.inv_keep : 0.f;
      }
      const float dl = e * ((d - st[2 * heads + h]) * inv);
      das += mm_round<T>(dl * (p >= 0.f ? 1.f : slope));
      coef[k] = mm_round<T>(ed);
      dpk[k] = inv;  // dp is spent: the slot now holds 1/denominator
    }
    das = warp_sum(das);
    if (lane == 0) dalpha[(size_t)s * two_h + h] = das;
    __syncwarp();
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int k = 0; k < cnt; ++k) {
        const float gs =
            mm_round<T>(to_f(gh[(size_t)recv[k] * g_ld + c]) * inv_heads * dpk[k]);
        acc = fmaf(coef[k], gs, acc);
      }
      dz[(size_t)s * hc + (size_t)h * C + c] = from_f<T>(acc);
    }
    __syncwarp();  // dpk and coef are rewritten by the next head
  }
}

template <typename T>
int launch(const int8_t* mask, const float* alphas, const void* z,
           const void* g, float* stats, void* dz, float* dalpha, int n_pad,
           int heads, int c, int tile, int wcols, float slope,
           bool mean_expand, Drop drop, cudaStream_t stream) {
  // head h's cotangent: row i of g [N, C] scaled by 1/H, or columns
  // h·C:(h+1)·C of row i of g [N, H·C]
  const int g_ld = mean_expand ? c : heads * c;
  const int g_head = mean_expand ? 0 : c;
  const float inv_heads = mean_expand ? 1.f / (float)heads : 1.f;
  const int blocks = (n_pad + WARPS - 1) / WARPS;
  const size_t smem_rows = (size_t)WARPS * wcols * 4 * sizeof(float);
  const size_t smem_cols = (size_t)WARPS * (wcols + tile) * 3 * sizeof(float);
  if (smem_rows > 48 * 1024 || smem_cols > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  gat_bwd_rows_kernel<T><<<blocks, 32 * WARPS, smem_rows, stream>>>(
      mask, alphas, static_cast<const T*>(z), static_cast<const T*>(g), stats,
      dalpha, n_pad, heads, c, tile, wcols, slope, g_ld, g_head, inv_heads,
      drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gat_bwd_cols_kernel<T><<<blocks, 32 * WARPS, smem_cols, stream>>>(
      mask, alphas, static_cast<const T*>(z), static_cast<const T*>(g), stats,
      static_cast<T*>(dz), dalpha, n_pad, heads, c, tile, wcols, slope,
      g_ld, g_head, inv_heads, drop);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (z, g and dz share it).  g is the
// head-mean cotangent [n_pad, c] (mean_expand = 1) or the per-head one
// [n_pad, heads·c] (mean_expand = 0).  stats is the caller-allocated
// [n_pad, 3·heads] f32 scratch.  seed: device pointer to one int32, or null
// for no dropout.  Returns the CUDA error code of the launches (0 on
// success).
int banded_gat_bwd_launch(const int8_t* mask, const float* alphas,
                          const void* z, const void* g, float* stats, void* dz,
                          float* dalpha, int n_pad, int heads, int c, int tile,
                          int wcols, float slope, int mean_expand, int dtype,
                          const int* seed, unsigned int thresh, float inv_keep,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, thresh, inv_keep};
  if (dtype == 0)
    return launch<float>(mask, alphas, z, g, stats, dz, dalpha, n_pad, heads,
                         c, tile, wcols, slope, mean_expand != 0, drop, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mask, alphas, z, g, stats, dz, dalpha, n_pad,
                                 heads, c, tile, wcols, slope,
                                 mean_expand != 0, drop, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
