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
// deterministic sums with no atomics and no partials, and only the first
// touches the softmax:
//
//  1. gat_bwd_recv_kernel — one warp per receiver row: compacts the mask
//     row (warp ballot, as the forward), forms every dp_ij of the row at
//     once (16-byte loads of z and g; the head-mean g row loaded once for
//     all heads; the H dot products of several senders reduced together),
//     recomputes the softmax, replays the dropout, and writes dα_dst,
//     1/denominator per (row, head), and at each nonzero (i, j) and head the
//     two values the sender pass sums, round(ẽ_ij) and round(dpre_ij), into
//     an [n_tiles, Wcols, T, H, 2] plane in z's dtype touched only at the
//     nonzeros (one window column's receivers and heads contiguous);
//  2. gat_bwd_send_kernel — one warp per sender row s: walks the column of
//     s in every receiver tile whose window holds it through the transposed
//     mask [n_tiles, Wcols, T] (one contiguous read per tile), so it needs
//     no symmetric adjacency; loads its receivers' pairs and 1/denominators
//     lane-parallel, then sums dα_src[s, h] = Σ_i round(dpre_ij) and
//     dz[s, h] = Σ_i round(ẽ_ij)·round(gout_i·inv_i,h) in f32 registers in
//     (tile, receiver) order, reading each receiver's g row once for all
//     heads (16-byte loads, several receivers in flight), and rounds dz
//     once.  No dot product, exp or hash.
//
// Both passes take heads in groups of four (the last one partial: its
// missing heads' loads, dp writes and stores masked) and a head row's columns in blocks of 256 (8 per lane: one 16-byte access
// in bf16, two in f32; 8-byte accesses for a bf16 C that is not a multiple
// of 8); the form with one full group and one block (H 4, C ≤ 256, the
// flagship) is compiled with those counts fixed.  Any H and any C that is
// a multiple of 4 run.
//
// The plane's values are bit-identical to what a recomputing sender pass
// would form (the same e, max, 1/denominator and rs), so dz and dα_src are
// the recomputing design's up to the f32 order of the dp dot products.
// dz rounds once (f32 sums, one cast) where the TPU kernel rounds each
// window partial to bf16 before an f32 fold: the two differ by a few bf16
// ulps in bf16 and by f32 summation order in f32.  Row 6
// (fold_project_bwd.cu) then takes dz rows directly.
//
// What bounds it on an H100: memory.  It must read z (24.6 MB at N 12,032,
// H·C 1,024, bf16), g, α and the mask and write dz (24.6 MB): ~59 MB, 18 µs
// at 3.35 TB/s (per head: g is as wide as z, ~78 MB, 23 µs); its
// arithmetic is the sparse products, 4·nnz·H·C operations.  The receiver
// pass re-reads the z rows of each receiver's ~5 senders and the sender pass
// the g rows of each sender's ~5 receivers, from L2 (about 120 MB and 30
// MB in the head-mean form: the passes are bound by L2 traffic and load
// latency, not by device memory); the plane adds 2·z's element size per
// nonzero and head, written once and read once.  The g rows are not staged
// in shared memory: a sender's receivers lie ±1 and ±(mesh width) rows
// away, so a block of neighbouring senders shares few of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"

namespace {

using band::Chunk;
using band::compact;
using band::load_flags;
using band::load_row;
using band::mm_round;
using band::warp_max;
using band::warp_sum;
using band::warp_sums;

constexpr int RECV_WARPS = 4;   // receiver rows per block
constexpr int SEND_WARPS = 4;   // sender rows per block
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_WGROUPS = 6;  // a mask row: Wcols ≤ 768, in 128-byte groups
constexpr int MAX_TGROUPS = 2;  // a mask column: T ≤ 256
constexpr int CB = 256;         // columns of a head row per lane sweep (8 a lane)

// round(ẽ), round(dpre) in z's dtype
template <typename T> struct Pair;
template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 make(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ float2 get(const float2& p) { return p; }
};
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 get(const __nv_bfloat162& p) {
    return __bfloat1622float2(p);
  }
};

template <typename T>
struct Args {
  const int8_t* mask;     // [n_tiles, T, Wcols]
  const int8_t* mask_t;   // [n_tiles, Wcols, T]
  const float* alphas;    // [n_pad, 2H] src | dst
  const T* z;             // [n_pad, H·C]
  const T* g;             // [n_pad, C] (mean) or [n_pad, H·C]
  float* inv;             // [n_pad, H]: 1/denominator
  typename Pair<T>::type* plane;  // [n_tiles, Wcols, T, H]
  T* dz;                  // [n_pad, H·C]
  float* dalpha;          // [n_pad, 2H]
  int n_pad, heads, C, tile, wcols;
  float slope, inv_heads;
  Drop drop;
};

// One warp per receiver row.  Heads go in groups of HG, a head row's
// columns in blocks of CB; EXACT: one group of exactly HG heads and one
// block (the flagship's H 4, C 256), known at compile time.  Shared memory
// per warp: the row's window columns idx[wcols], one head's pre-activations
// then exps ev[wcols], and dp[wcols·H].
template <typename T, int HG, int V, bool MEAN, bool EXACT>
__global__ void __launch_bounds__(32 * RECV_WARPS) gat_bwd_recv_kernel(Args<T> a) {
  using Ch = Chunk<T, V>;
  constexpr int NG = CB / (32 * V), MC = V * NG;
  constexpr int GR = MEAN ? 1 : HG;                 // cotangent rows per block
  constexpr int U = HG * NG >= 8 ? 1 : 8 / (HG * NG);  // senders in flight
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * RECV_WARPS + warp;
  if (row >= a.n_pad) return;  // whole warp: no block-wide barrier below
  const int wcols = a.wcols, tile = a.tile, C = a.C;
  const int heads = EXACT ? HG : a.heads, blocks = EXACT ? 1 : (C + CB - 1) / CB;
  const int hc = heads * C;
  int* idx = reinterpret_cast<int*>(smem) + (size_t)warp * (2 + heads) * wcols;
  float* ev = reinterpret_cast<float*>(idx + wcols);
  float* dp = ev + wcols;

  const int t = row / tile, r = row % tile;
  const int s0 = t * tile - (wcols - tile) / 2;
  uint32_t mw[MAX_WGROUPS];
  load_flags<MAX_WGROUPS>(a.mask + (size_t)row * wcols, wcols, lane, mw);
  const int cnt = compact<MAX_WGROUPS>(
      mw, wcols, lane, idx, 0,
      [&](int j) { return s0 + j >= 0 && s0 + j < a.n_pad; },
      [](int j) { return j; });
  __syncwarp();

  // dp for every (sender, head): per head group and column block, round(gout)
  // once, then U senders' z rows loaded together (lane u also brings sender
  // u's α_src into L1 for the softmax) and their U·HG dot products reduced
  // together, added to the earlier blocks' in dp
  for (int hg0 = 0; hg0 < heads; hg0 += HG)
    for (int b = 0; b < blocks; ++b) {
      const int cb = b * CB;
      float gf[GR][MC];
#pragma unroll
      for (int q = 0; q < GR; ++q) {
        typename Ch::raw u[NG];
        load_row<T, V, NG>(a.g + (size_t)row * (MEAN ? C : hc) + (size_t)(MEAN ? 0 : hg0 + q) * C,
                           cb, C, lane, MEAN || hg0 + q < heads, u);
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) Ch::unpack(u[gi], &gf[q][V * gi]);
#pragma unroll
        for (int e = 0; e < MC; ++e) gf[q][e] = mm_round<T>(gf[q][e] * a.inv_heads);
      }
      for (int k0 = 0; k0 < cnt; k0 += U) {
        typename Ch::raw zu[U][HG][NG];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = k0 + u < cnt ? s0 + idx[k0 + u] : s0 + idx[k0];
#pragma unroll
          for (int h = 0; h < HG; ++h)
            load_row<T, V, NG>(a.z + (size_t)s * hc + (size_t)(hg0 + h) * C, cb, C, lane,
                               hg0 + h < heads, zu[u][h]);
        }
        if (hg0 == 0 && cb == 0 && lane < U && k0 + lane < cnt)
          asm volatile("prefetch.global.L1 [%0];" ::"l"(
              a.alphas + (size_t)(s0 + idx[k0 + lane]) * 2 * heads));
        float p[U * HG];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int h = 0; h < HG; ++h) {
            float part = 0.f;
#pragma unroll
            for (int gi = 0; gi < NG; ++gi) {
              float zv[V];
              Ch::unpack(zu[u][h][gi], zv);
#pragma unroll
              for (int e = 0; e < V; ++e)
                part = fmaf(gf[MEAN ? 0 : h][V * gi + e], zv[e], part);
            }
            p[u * HG + h] = part;
          }
        warp_sums<U * HG>(p);
#pragma unroll
        for (int q = 0; q < U * HG; ++q) {
          const int k = k0 + q / HG, h = hg0 + q % HG;
          if (lane == q % 32 && k < cnt && h < heads) {
            float* d = dp + k * heads + h;
            *d = cb == 0 ? p[q] : *d + p[q];
          }
        }
      }
    }
  __syncwarp();

  const uint32_t sv = a.drop.seed != nullptr ? (uint32_t)a.drop.seed[0] + (uint32_t)t : 0u;
  using P = Pair<T>;
  typename P::type* pl = a.plane + (size_t)t * wcols * tile * heads + (size_t)r * heads;
  for (int h = 0; h < heads; ++h) {
    // pre-activation a_dst + a_src, in the forward's order; then ev holds
    // e with the pre-activation's sign (signbit picks LeakyReLU's slope,
    // ±0 included)
    const float ad = a.alphas[(size_t)row * 2 * heads + heads + h];
    float mx = -CUDART_INF_F;
    for (int k = lane; k < cnt; k += 32) {
      const float pr = ad + a.alphas[(size_t)(s0 + idx[k]) * 2 * heads + h];
      ev[k] = pr;
      mx = fmaxf(mx, pr >= 0.f ? pr : a.slope * pr);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const float pr = ev[k];
      const float e = expf((pr >= 0.f ? pr : a.slope * pr) - mx);
      ev[k] = pr >= 0.f ? e : -e;
      sum += e;
    }
    const float inv = 1.f / fmaxf(warp_sum(sum), 1e-16f);
    const uint32_t plane_row = (uint32_t)(h * tile + r) * (uint32_t)wcols;
    float s1 = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const float e = fabsf(ev[k]);
      float d = dp[k * heads + h];
      if (a.drop.seed != nullptr) {
        d = dropout_hash(sv, plane_row + (uint32_t)idx[k]) >= a.drop.thresh
                ? d * a.drop.inv_keep : 0.f;
        dp[k * heads + h] = d;
      }
      s1 += e * d;
    }
    const float rs = warp_sum(s1) * inv;
    float s2 = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const int j = idx[k];
      const float e = fabsf(ev[k]);
      const float dpre = e * ((dp[k * heads + h] - rs) * inv) * (signbit(ev[k]) ? a.slope : 1.f);
      s2 += dpre;
      float ed = e;
      if (a.drop.seed != nullptr)
        ed = dropout_hash(sv, plane_row + (uint32_t)j) >= a.drop.thresh
                 ? e * a.drop.inv_keep : 0.f;
      pl[(size_t)j * tile * heads + h] = P::make(ed, dpre);
    }
    const float dad = warp_sum(s2);
    if (lane == 0) {
      a.inv[(size_t)row * heads + h] = inv;
      a.dalpha[(size_t)row * 2 * heads + heads + h] = dad;
    }
    __syncwarp();  // ev is rewritten by the next head
  }
}

// One warp per sender row s: its receivers are rows r of the tiles t whose
// window [t·T − pad, t·T − pad + Wcols) holds s, with mask[r, s + pad −
// t·T] = 1, listed in (t, r) order: at most ceil(Wcols / T)·T ≤ Wcols + T
// of them.  Shared memory per warp: that list.  Per head group and column
// block (one of each at the flagship's shape), a chunk of 32 receivers'
// round(ẽ) and 1/denominators sit in their lanes' registers and reach the
// warp by shuffles, so their g rows' loads go out beside them.
template <typename T, int HG, int V, bool MEAN, bool EXACT>
__global__ void __launch_bounds__(32 * SEND_WARPS) gat_bwd_send_kernel(Args<T> a) {
  using Ch = Chunk<T, V>;
  constexpr int NG = CB / (32 * V), MC = V * NG;
  constexpr int GR = MEAN ? 1 : HG;
  constexpr int U = GR * NG >= 8 ? 1 : 8 / (GR * NG);   // receivers in flight
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * SEND_WARPS + warp;
  if (s >= a.n_pad) return;
  const int wcols = a.wcols, tile = a.tile, C = a.C;
  const int heads = EXACT ? HG : a.heads, blocks = EXACT ? 1 : (C + CB - 1) / CB;
  const int hc = heads * C;
  int* recv = reinterpret_cast<int*>(smem) + (size_t)warp * ((wcols + tile + 3) & ~3);

  const int pad = (wcols - tile) / 2;
  const int n_tiles = a.n_pad / tile;
  const int t_hi = min((s + pad) / tile, n_tiles - 1);
  const int t_lo = max(0, (s + pad - wcols) / tile);
  // the column of s in each tile through the transposed mask, the next
  // tile's words loaded before this tile's are compacted
  auto column = [&](int t) { return a.mask_t + ((size_t)t * wcols + (s + pad - t * tile)) * tile; };
  auto holds = [&](int t) { const int w = s + pad - t * tile; return w >= 0 && w < wcols; };
  uint32_t cur[MAX_TGROUPS], nxt[MAX_TGROUPS];
#pragma unroll
  for (int g = 0; g < MAX_TGROUPS; ++g) cur[g] = 0u;
  if (holds(t_lo)) load_flags<MAX_TGROUPS>(column(t_lo), tile, lane, cur);
  int cnt = 0;
  for (int t = t_lo; t <= t_hi; ++t) {
#pragma unroll
    for (int g = 0; g < MAX_TGROUPS; ++g) nxt[g] = 0u;
    if (t < t_hi && holds(t + 1)) load_flags<MAX_TGROUPS>(column(t + 1), tile, lane, nxt);
    if (holds(t))
      cnt = compact<MAX_TGROUPS>(cur, tile, lane, recv, cnt, [](int) { return true; },
                                 [&](int i) { return t * tile + i; });
#pragma unroll
    for (int g = 0; g < MAX_TGROUPS; ++g) cur[g] = nxt[g];
  }
  __syncwarp();

  using P = Pair<T>;
  for (int hg0 = 0; hg0 < heads; hg0 += HG)
    for (int b = 0; b < blocks; ++b) {
      const int cb = b * CB;
      float acc[HG][MC];
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int e = 0; e < MC; ++e) acc[h][e] = 0.f;
      float das[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) das[h] = 0.f;

      for (int k0 = 0; k0 < cnt; k0 += 32) {
        // the chunk's pairs and 1/denominators, one receiver per lane
        const int k = k0 + lane;
        float co[HG], fi[HG];
#pragma unroll
        for (int h = 0; h < HG; ++h) co[h] = fi[h] = 0.f;
        if (k < cnt) {
          const int r = recv[k];
          const int t = r / tile;
          const typename P::type* pr =
              a.plane + (((size_t)t * wcols + (s + pad - t * tile)) * tile + r % tile) * heads;
#pragma unroll
          for (int h = 0; h < HG; ++h)
            if (hg0 + h < heads) {
              const float2 v = P::get(pr[hg0 + h]);
              co[h] = v.x;
              das[h] += v.y;
              fi[h] = a.inv[(size_t)r * heads + hg0 + h];
            }
        }
        const int m = min(32, cnt - k0);
        for (int kk = 0; kk < m; kk += U) {
          typename Ch::raw gu[U][GR][NG];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int r = recv[k0 + (kk + u < m ? kk + u : kk)];
#pragma unroll
            for (int q = 0; q < GR; ++q)
              load_row<T, V, NG>(a.g + (size_t)r * (MEAN ? C : hc) + (size_t)(MEAN ? 0 : hg0 + q) * C,
                                 cb, C, lane, MEAN || hg0 + q < heads, gu[u][q]);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (kk + u >= m) break;
#pragma unroll
            for (int h = 0; h < HG; ++h) {
              const float c = __shfl_sync(0xffffffffu, co[h], kk + u);
              const float f = __shfl_sync(0xffffffffu, fi[h], kk + u);
#pragma unroll
              for (int gi = 0; gi < NG; ++gi) {
                float gv[V];
                Ch::unpack(gu[u][MEAN ? 0 : h][gi], gv);
#pragma unroll
                for (int e = 0; e < V; ++e)
                  acc[h][V * gi + e] =
                      fmaf(c, mm_round<T>(gv[e] * a.inv_heads * f), acc[h][V * gi + e]);
              }
            }
          }
        }
      }

      if (cb == 0) {
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          const float d = warp_sum(das[h]);
          if (lane == 0 && hg0 + h < heads) a.dalpha[(size_t)s * 2 * heads + hg0 + h] = d;
        }
      }
#pragma unroll
      for (int h = 0; h < HG; ++h)
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const int c = cb + V * lane + 32 * V * gi;
          if (hg0 + h < heads && c < C)
            *reinterpret_cast<typename Ch::raw*>(a.dz + (size_t)s * hc + (size_t)(hg0 + h) * C + c) =
                Ch::pack(&acc[h][V * gi]);
        }
    }
}

template <typename T, int HG, int V, bool MEAN, bool EXACT>
int run(const Args<T>& a, cudaStream_t stream) {
  const size_t smem_recv = (size_t)RECV_WARPS * (2 + a.heads) * a.wcols * 4;
  const size_t smem_send = (size_t)SEND_WARPS * ((a.wcols + a.tile + 3) & ~3) * 4;
  if (smem_recv > SMEM_MAX || smem_send > SMEM_MAX || a.wcols % 4 || a.tile % 4
      || a.wcols > 128 * MAX_WGROUPS || a.tile > 128 * MAX_TGROUPS || a.C % V)
    return (int)cudaErrorInvalidValue;
  auto recv = gat_bwd_recv_kernel<T, HG, V, MEAN, EXACT>;
  auto send = gat_bwd_send_kernel<T, HG, V, MEAN, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      recv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_recv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(send, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_send);
  if (err != cudaSuccess) return (int)err;
  recv<<<(a.n_pad + RECV_WARPS - 1) / RECV_WARPS, 32 * RECV_WARPS, smem_recv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  send<<<(a.n_pad + SEND_WARPS - 1) / SEND_WARPS, 32 * SEND_WARPS, smem_send, stream>>>(a);
  return (int)cudaGetLastError();
}

// head groups of 4, the EXACT form when the heads fill one group and C one
// block; 16-byte accesses, or 8-byte ones for a bf16 C that is not a
// multiple of 8
template <typename T, int V, bool MEAN>
int dispatch_h(const Args<T>& a, cudaStream_t stream) {
  if (a.heads == 4 && a.C <= CB) return run<T, 4, V, MEAN, true>(a, stream);
  return run<T, 4, V, MEAN, false>(a, stream);
}

template <typename T, bool MEAN>
int dispatch_v(const Args<T>& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (a.C % 8) return dispatch_h<T, 4, MEAN>(a, stream);
    return dispatch_h<T, 8, MEAN>(a, stream);
  } else {
    return dispatch_h<T, 4, MEAN>(a, stream);
  }
}

template <typename T>
int launch(const int8_t* mask, const int8_t* mask_t, const float* alphas,
           const void* z, const void* g, float* inv, void* plane, void* dz,
           float* dalpha, int n_pad, int heads, int c, int tile, int wcols,
           float slope, bool mean_expand, Drop drop, cudaStream_t stream) {
  if (heads < 1) return (int)cudaErrorInvalidValue;
  const Args<T> a{mask, mask_t, alphas, static_cast<const T*>(z),
                  static_cast<const T*>(g), inv,
                  static_cast<typename Pair<T>::type*>(plane),
                  static_cast<T*>(dz), dalpha, n_pad, heads, c, tile, wcols,
                  slope, mean_expand ? 1.f / (float)heads : 1.f, drop};
  return mean_expand ? dispatch_v<T, true>(a, stream)
                     : dispatch_v<T, false>(a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (z, g, dz and the plane share it).  g is
// the head-mean cotangent [n_pad, c] (mean_expand = 1) or the per-head one
// [n_pad, heads·c] (mean_expand = 0); c a multiple of 4; z, g and dz
// 16-byte aligned.  mask_t: the mask transposed to [n_pad / tile, wcols,
// tile] (wcols ≤ 768 and tile ≤ 256, both multiples of 4).  inv: the
// caller-allocated [n_pad, heads] f32 scratch; plane: the caller-allocated
// [n_pad / tile, wcols, tile, heads, 2] scratch in dtype, written and read
// only at the mask's nonzeros.  seed: device pointer to one int32, or null
// for no dropout.  Returns the CUDA error code of the launches (0 on
// success).
int banded_gat_bwd_launch(const int8_t* mask, const int8_t* mask_t,
                          const float* alphas, const void* z, const void* g,
                          float* inv, void* plane, void* dz, float* dalpha,
                          int n_pad, int heads, int c, int tile, int wcols,
                          float slope, int mean_expand, int dtype,
                          const int* seed, unsigned int thresh, float inv_keep,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, thresh, inv_keep};
  if (dtype == 0)
    return launch<float>(mask, mask_t, alphas, z, g, inv, plane, dz, dalpha,
                         n_pad, heads, c, tile, wcols, slope, mean_expand != 0,
                         drop, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mask, mask_t, alphas, z, g, inv, plane, dz,
                                 dalpha, n_pad, heads, c, tile, wcols, slope,
                                 mean_expand != 0, drop, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
