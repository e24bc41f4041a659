// Banded Transformer backward: plain, edge-conditioned and factorised
// geometric; head-mean or concat cotangent; with or without the cotangent
// of s; attention dropout replayed.
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded_bwd.py::
// banded_transformer_bwd (_tr_bwd_kernel / _tr_bwd_kernel_stacked, which
// differ only in summation order) in its partials mode (raw_kv_partials):
// given the forward's inputs and the cotangents g of out ([N, C] head mean,
// g/H per head; or [N, H·C]) and gs of s (f32 [N, H·D], optional), it
// returns
//
//   dq [N, H·C] (q's dtype), dqw [N, H·D] f32, and the dk / dv window
//   partials [n_tiles, W_sub, sub, H·C] (k's / v's dtype),
//
// with, for receiver i, head h and each sender j of i's window (mask 1):
//
//   l_ij, e_ij, inv_i          the forward's logit, exp(l − max l) and
//                              1 / max(Σ_j e, 1e-16) (banded_transformer.cu)
//   dp_ij = round(g_h,i)·v_j   + Σ_d gs_d·feat_d[i, j]               (edge)
//                              + (gs·pos_i − gs·pos_j)·invd + gs_3·dist (geo)
//   keep replay: ẽ = e·keep/(1 − rate), dp ← dp·keep/(1 − rate)
//   rs_i  = inv_i · Σ_j e_ij·dp_ij,   dl_ij = (e_ij·((dp_ij − rs_i)·inv_i))·scale
//   dq_i  = Σ_j round(dl_ij)·k_j
//   dqw_i = Σ_j dl_ij·feat_d (edge); (pos_i·Σ dl·invd − Σ dl·invd·pos_j,
//           Σ dl·dist) (geo)
//   dk_j += round(dl_ij)·q_i,    dv_j += round(ẽ_ij)·round(g_h,i·inv_i)
//
// where round() is the TPU kernels' bf16 rounding point (_mm_cast) in bf16
// and the identity in f32.  rs and dl use the undropped e and the dropped
// dp; the dv product the dropped ẽ.  A row with no sender writes dq = dqw
// = 0.  Each window partial [t, k] sums, in f32, the contributions of tile
// t's receivers to the senders of window block k, and rounds once to k's
// (v's) dtype; fold_partials.cu folds them into rows.
//
// The TPU kernel computes the whole [T, Wcols] plane per head on its
// matrix unit.  Here two passes touch only the mask's nonzeros, with no
// atomics, in a fixed order:
//
//  1. tr_bwd_rows_kernel — one warp per receiver row: compacts the mask row
//     (warp ballot, as the forward), forms the logits and dp by warp dot
//     products (4·NG values per lane, C ≤ 128·NG a template parameter; the
//     k and v rows of 4/NG senders, and for dq the k rows of 8/NG, loaded
//     before their reductions, so the loads overlap), writes dq, dqw,
//     1/denominator per (row, head), and at each nonzero (i, j) and head the
//     two values pass 2 sums, round(dl_ij) and round(ẽ_ij), into an
//     [n_tiles, H, Wcols, T, 2] f32 plane touched only at the nonzeros (a
//     column's receivers contiguous: pass 2 reads them in one coalesced
//     load per 32 rows).  The dropout replay and all conditioning (edge,
//     geo, gs) live here alone;
//  2. tr_bwd_parts_kernel — one block per (receiver tile, head): stages the
//     tile's mask, its q_h rows and G'_h = round(g_h·inv) rows in shared
//     memory (all of C in bf16 up to C 256; 128 columns at a time in f32,
//     whose two tiles of [T, C] would not fit); a warp takes four window
//     columns at a time, loads their receivers' (dl, ẽ) pairs together,
//     and sums dk[t, w, h] = Σ_i dl_iw·q_h,i and dv[t, w, h] =
//     Σ_i ẽ_iw·G'_h,i from shared memory (no recompute; no global loads but
//     the pairs, no shuffles but their broadcast), then rounds once.  A
//     column without a receiver writes zero rows.
//
// The plane's values are bit-identical to the ones pass 2 used to
// recompute (the same e, max, 1/denominator and rs), so the partials are
// those of the recomputing design up to the f32 summation order, which is
// the same (receivers in ascending order).
//
// What bounds it on an H100: bytes.  q, k, v and g are read (24.6 MB each
// at N 12,032, H·C 1,024 in bf16; g 6.2 MB in the head-mean form), dq
// written (24.6 MB) and the two partial arrays written (49.3 MB each at
// Wcols 256): ~200 MB, ~60 µs at 3.35 TB/s; the plane adds 8 bytes per
// nonzero and head, written once and read once.  The arithmetic, 2·C
// operations per nonzero, head and product for the logit, dp, dq, dk and
// dv, is ~0.4 GFLOP.
//
// Registers and blocks per SM at C 256 in bf16 (nvcc 12.9 -Xptxas -v,
// sm_90a): pass 1 79 registers, six blocks of four warps per SM (the
// launch bound); pass 2 126 registers and 161 KB of shared memory at Wcols
// 256, one block of 16 warps per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;  // warps per block in the receiver pass
constexpr int PART_THREADS = 512;  // threads per block in the partials pass
constexpr int PART_CC = 128;       // columns of C staged at a time
constexpr int PART_WCOLS = 4;      // window columns per warp in flight
constexpr int PART_SMEM_MAX = 224 * 1024;
constexpr int MAX_DE = 8;

enum Mode { PLAIN = 0, EDGE = 1, GEO = 2 };

using band::load4;
using band::mm_round;
using band::store4;
using band::to_f;
using band::warp_sum;

struct Args {
  const int8_t* mask;   // [n_tiles, T, Wcols]
  const void* q;        // rows of stride ld, heads h·C…
  const void* k;
  const void* v;
  int ld;
  const float* feat;    // EDGE [nt, D, T, Wc]; GEO [nt, 2, T, Wc]
  const float* pos;     // GEO [n_pad, 4]
  const void* qw;       // [n_pad, H·D] (EDGE, GEO)
  const void* g;        // [n_pad, C] (mean) or [n_pad, H·C]
  const float* gs;      // [n_pad, H·D] f32 or null
  float* inv;           // [n_pad, H]: 1/denominator
  float2* plane;        // [n_tiles, H, Wcols, T]: (round(dl), round(ẽ)) at
                        // the nonzeros
  void* dq;             // [n_pad, H·C]
  float* dqw;           // [n_pad, H·D]
  void* dk;             // [n_tiles, Wcols, H·C] partials
  void* dv;
  int n_pad, heads, C, tile, wcols, edge_dim, mean;
  float scale, inv_heads;
  Drop drop;
};

// a lane's columns 4·lane + 128·g … (g < NG) of one head's C values
template <int NG, typename T>
__device__ __forceinline__ void load_head(const T* row, int C, int lane,
                                          float v[4 * NG]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = 4 * lane + 128 * g;
    if (c < C) {
      load4(row + c, &v[4 * g]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * g + e] = 0.f;
    }
  }
}

template <int NG, typename T>
__device__ __forceinline__ void store_head(T* row, int C, int lane,
                                           const float v[4 * NG]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = 4 * lane + 128 * g;
    if (c < C) store4(row + c, &v[4 * g]);
  }
}

// the lane's part of Σ_c a_c·b_c, in the forward kernel's order
template <int NG>
__device__ __forceinline__ float dot_part(const float a[4 * NG],
                                          const float b[4 * NG]) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < 4 * NG; ++j) part = fmaf(a[j], b[j], part);
  return part;
}

// U warp sums at once (the shuffles of independent sums interleave)
template <int U>
__device__ __forceinline__ void warp_sums(float (&v)[U]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] += __shfl_xor_sync(0xffffffffu, v[u], o);
}

// A receiver's per-head conditioning: qe (qw·scale_q, edge; qw·scale, geo),
// qself (geo), and the cotangent of s, gse, with gs_self (geo).
template <typename T, int MODE>
struct Cond {
  float qe[MAX_DE], gse[MAX_DE];
  float pos_i[4];
  float qself = 0.f, gs_self = 0.f;

  __device__ __forceinline__ void load(const Args& a, int row, int h) {
    const int d_e = MODE == GEO ? 4 : MODE == EDGE ? a.edge_dim : 0;
    const T* qw = static_cast<const T*>(a.qw);
    if (MODE == GEO) {
#pragma unroll
      for (int d = 0; d < 4; ++d) pos_i[d] = a.pos[(size_t)row * 4 + d];
    }
    const float scale_q = mm_round<T>(a.scale);
#pragma unroll
    for (int d = 0; d < MAX_DE; ++d) {
      const bool on = d < d_e;
      const size_t at = (size_t)row * a.heads * d_e + h * d_e + d;
      qe[d] = on ? to_f(qw[at]) * (MODE == EDGE ? scale_q : a.scale) : 0.f;
      gse[d] = on && a.gs != nullptr ? a.gs[at] : 0.f;
    }
    if (MODE == GEO) {
      qself = qe[0] * pos_i[0] + qe[1] * pos_i[1] + qe[2] * pos_i[2] + qe[3] * pos_i[3];
      gs_self = gse[0] * pos_i[0] + gse[1] * pos_i[1] + gse[2] * pos_i[2]
                + gse[3] * pos_i[3];
    }
  }

  // the conditioned logit from the warp's q·k·scale at window column j
  __device__ __forceinline__ float logit(float l, const Args& a,
                                         const float* frow, size_t plane,
                                         int j, const float* pj) const {
    if (MODE == EDGE) {
#pragma unroll
      for (int d = 0; d < MAX_DE; ++d)
        if (d < a.edge_dim) l += qe[d] * frow[d * plane + j];
    }
    if (MODE == GEO) {
      const float dist = frow[j], invd = frow[plane + j];
      const float qpos = qe[0] * pj[0] + qe[1] * pj[1] + qe[2] * pj[2] + qe[3] * pj[3];
      l = l + (qself - qpos) * invd + qe[3] * dist;
    }
    return l;
  }

  // dp with the cotangent of s
  __device__ __forceinline__ float dp(float d, const Args& a,
                                      const float* frow, size_t plane, int j,
                                      const float* pj) const {
    if (a.gs == nullptr) return d;
    if (MODE == EDGE) {
#pragma unroll
      for (int e = 0; e < MAX_DE; ++e)
        if (e < a.edge_dim) d += gse[e] * frow[e * plane + j];
    }
    if (MODE == GEO) {
      const float dist = frow[j], invd = frow[plane + j];
      const float gsp = gse[0] * pj[0] + gse[1] * pj[1] + gse[2] * pj[2] + gse[3] * pj[3];
      d = d + (gs_self - gsp) * invd + gse[3] * dist;
    }
    return d;
  }
};

template <typename T, int MODE, int NG>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK, 6) tr_bwd_rows_kernel(Args a) {
  constexpr int MC = 4 * NG;     // values per lane of one head row
  constexpr int U = NG >= 4 ? 1 : 4 / NG;   // sender rows in flight per warp
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= a.n_pad) return;  // whole warp: no block-wide barrier below
  const int wcols = a.wcols, tile = a.tile, C = a.C;
  int* idx = reinterpret_cast<int*>(smem) + warp * 3 * wcols;
  float* el = reinterpret_cast<float*>(idx + wcols);   // logit, e, then dl
  float* dpv = el + wcols;

  const int t = row / tile, r = row % tile;
  const int s0 = t * tile - (wcols - tile) / 2;
  const int8_t* mrow = a.mask + (size_t)row * wcols;
  int cnt = 0;
  for (int base = 0; base < wcols; base += 32) {
    const int j = base + lane;
    const int s = s0 + j;
    const bool on = j < wcols && s >= 0 && s < a.n_pad && mrow[j] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (on) idx[cnt + __popc(bal & ((1u << lane) - 1u))] = j;
    cnt += __popc(bal);
  }
  __syncwarp();

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const int d_e = MODE == GEO ? 4 : MODE == EDGE ? a.edge_dim : 0;
  const size_t plane = (size_t)tile * wcols;
  const float* frow = MODE == PLAIN ? nullptr
                      : a.feat + (size_t)t * (MODE == GEO ? 2 : d_e) * plane
                            + (size_t)r * wcols;
  const uint32_t sv = a.drop.seed != nullptr ? (uint32_t)a.drop.seed[0] + (uint32_t)t : 0u;
  const int hc = a.heads * C;

  for (int h = 0; h < a.heads; ++h) {
    float qv[MC], gv[MC];
    load_head<NG>(q + (size_t)row * a.ld + (size_t)h * C, C, lane, qv);
    load_head<NG>(a.mean ? g + (size_t)row * C : g + (size_t)row * hc + (size_t)h * C,
                  C, lane, gv);
#pragma unroll
    for (int j = 0; j < MC; ++j)
      gv[j] = mm_round<T>(a.mean ? gv[j] * a.inv_heads : gv[j]);
    Cond<T, MODE> cond;
    cond.load(a, row, h);
    // this row's pairs: plane[t, h, j, r]
    float* pl = reinterpret_cast<float*>(a.plane + ((size_t)t * a.heads + h) * plane + r);

    // logits and dp, U senders at a time
    float mx = -CUDART_INF_F;
    for (int kk0 = 0; kk0 < cnt; kk0 += U) {
      float kv[U][MC], vv[U][MC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = kk0 + u < cnt ? s0 + idx[kk0 + u] : 0;
        load_head<NG>(k + (size_t)s * a.ld + (size_t)h * C, C, lane, kv[u]);
        load_head<NG>(v + (size_t)s * a.ld + (size_t)h * C, C, lane, vv[u]);
      }
      float pk[U], pv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pk[u] = dot_part<NG>(qv, kv[u]);
        pv[u] = dot_part<NG>(gv, vv[u]);
      }
      warp_sums<U>(pk);
      warp_sums<U>(pv);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kk0 + u;
        if (kk >= cnt) break;
        const int j = idx[kk];
        const float* pj = MODE == GEO ? a.pos + (size_t)(s0 + j) * 4 : nullptr;
        const float l = cond.logit(pk[u] * a.scale, a, frow, plane, j, pj);
        const float d = cond.dp(pv[u], a, frow, plane, j, pj);
        if (lane == 0) {
          el[kk] = l;
          dpv[kk] = d;
        }
        mx = fmaxf(mx, l);
      }
    }
    __syncwarp();
    float sum = 0.f;
    for (int kk = lane; kk < cnt; kk += 32) {
      const float e = expf(el[kk] - mx);
      el[kk] = e;
      sum += e;
    }
    const float inv = 1.f / fmaxf(warp_sum(sum), 1e-16f);
    float s1 = 0.f;
    for (int kk = lane; kk < cnt; kk += 32) {
      float d = dpv[kk];
      float ed = el[kk];
      if (a.drop.seed != nullptr) {
        const uint32_t flat = (uint32_t)r * (uint32_t)wcols + (uint32_t)idx[kk];
        const bool keep = dropout_hash(sv, flat, (uint32_t)h) >= a.drop.thresh;
        d = keep ? d * a.drop.inv_keep : 0.f;
        ed = keep ? ed * a.drop.inv_keep : 0.f;
      }
      dpv[kk] = d;
      pl[(size_t)idx[kk] * tile * 2 + 1] = mm_round<T>(ed);   // ẽ
      s1 += el[kk] * d;
    }
    const float rs = warp_sum(s1) * inv;
    for (int kk = lane; kk < cnt; kk += 32) {
      const float dl = (el[kk] * ((dpv[kk] - rs) * inv)) * a.scale;
      el[kk] = dl;
      pl[(size_t)idx[kk] * tile * 2] = mm_round<T>(dl);
    }
    __syncwarp();

    // dq = Σ round(dl)·k, 2·U senders at a time (no v rows here)
    float acc[MC];
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[j] = 0.f;
    for (int kk0 = 0; kk0 < cnt; kk0 += 2 * U) {
      float kv[2 * U][MC];
#pragma unroll
      for (int u = 0; u < 2 * U; ++u) {
        const int s = kk0 + u < cnt ? s0 + idx[kk0 + u] : 0;
        load_head<NG>(k + (size_t)s * a.ld + (size_t)h * C, C, lane, kv[u]);
      }
#pragma unroll
      for (int u = 0; u < 2 * U; ++u) {
        if (kk0 + u >= cnt) break;
        const float dl = mm_round<T>(el[kk0 + u]);
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[j] = fmaf(dl, kv[u][j], acc[j]);
      }
    }
    store_head<NG>(static_cast<T*>(a.dq) + (size_t)row * hc + (size_t)h * C, C,
                   lane, acc);

    // dqw: the conditioning planes weighted by dl, lanes over senders
    if (MODE == EDGE) {
      for (int d = 0; d < d_e; ++d) {
        float part = 0.f;
        for (int kk = lane; kk < cnt; kk += 32)
          part = fmaf(el[kk], frow[d * plane + idx[kk]], part);
        part = warp_sum(part);
        if (lane == 0) a.dqw[(size_t)row * a.heads * d_e + h * d_e + d] = part;
      }
    }
    if (MODE == GEO) {
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f, s3 = 0.f;
      for (int kk = lane; kk < cnt; kk += 32) {
        const int j = idx[kk];
        const float dl = el[kk];
        const float u = dl * frow[plane + j];
        const float* pj = a.pos + (size_t)(s0 + j) * 4;
        t0 += u;
        t1 = fmaf(u, pj[0], t1);
        t2 = fmaf(u, pj[1], t2);
        t3 = fmaf(u, pj[2], t3);
        s3 = fmaf(dl, frow[j], s3);
      }
      t0 = warp_sum(t0);
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      t3 = warp_sum(t3);
      s3 = warp_sum(s3);
      if (lane == 0) {
        float* drow = a.dqw + (size_t)row * a.heads * 4 + h * 4;
        drow[0] = cond.pos_i[0] * t0 - t1;
        drow[1] = cond.pos_i[1] * t0 - t2;
        drow[2] = cond.pos_i[2] * t0 - t3;
        drow[3] = s3;
      }
    }
    if (lane == 0) a.inv[(size_t)row * a.heads + h] = inv;
    __syncwarp();  // el, dpv are rewritten by the next head
  }
}

// The partials pass's shared memory: q_h and G'_h rows [T][cc] in the
// primal dtype, then the tile's mask [T][Wcols + 4] (the pad spreads a
// column's rows over the banks).
template <typename T>
__host__ __device__ constexpr size_t parts_smem(int tile, int cc, int wcols) {
  return 2 * (size_t)tile * cc * sizeof(T) + (size_t)tile * (wcols + 4);
}

// One block per (receiver tile t, head h): the tile's partial rows
// dk[t, w, h] and dv[t, w, h] over every window column w (sender
// s = t·T − pad + w), from pass 1's plane.
// MAX_GROUPS: receiver groups of 32 (T ≤ 32·MAX_GROUPS); NGC: the staged
// columns cc ≤ 128·NGC, 4·NGC per lane
template <typename T, int MAX_GROUPS, int NGC>
__global__ void __launch_bounds__(PART_THREADS) tr_bwd_parts_kernel(Args a, int cc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = a.tile, wcols = a.wcols, C = a.C, heads = a.heads;
  const int t = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mp = wcols + 4;
  T* qs = reinterpret_cast<T*>(smem);
  T* gsm = qs + (size_t)tile * cc;
  int8_t* ms = reinterpret_cast<int8_t*>(gsm + (size_t)tile * cc);
  const uint32_t* mtile = reinterpret_cast<const uint32_t*>(a.mask + (size_t)t * tile * wcols);
  for (int e = threadIdx.x; e < tile * (wcols / 4); e += PART_THREADS) {
    const int i = e / (wcols / 4), j4 = e % (wcols / 4);
    *reinterpret_cast<uint32_t*>(ms + i * mp + 4 * j4) = mtile[e];
  }
  const T* q = static_cast<const T*>(a.q);
  const T* g = static_cast<const T*>(a.g);
  const int pad = (wcols - tile) / 2, hc = heads * C;
  // this (tile, head)'s pairs: column w's receivers are contiguous
  const float2* plane = a.plane + ((size_t)t * heads + h) * wcols * tile;
  // a column's pairs and receiver ballots (T ≤ 256: at most 8 groups of
  // 32), one coalesced load per group
  auto fetch = [&](int w, float2 (&de)[MAX_GROUPS], unsigned (&bal)[MAX_GROUPS]) {
    const int s = t * tile - pad + w;
    const bool in_range = w < wcols && s >= 0 && s < a.n_pad;
#pragma unroll
    for (int gi = 0; gi < MAX_GROUPS; ++gi) {
      const int i = 32 * gi + lane;
      const bool on = in_range && i < tile && ms[i * mp + w] != 0;
      de[gi] = on ? plane[(size_t)w * tile + i] : make_float2(0.f, 0.f);
      bal[gi] = 32 * gi < tile ? __ballot_sync(0xffffffffu, on) : 0u;
    }
  };
  constexpr int NW = PART_THREADS / 32;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int width = min(cc, C - c0), w4 = width / 4;
    // q_h and G'_h = round(g_h·inv) (g/H first in the head-mean form), four
    // rows' loads in flight per thread
    for (int e0 = threadIdx.x; e0 < tile * w4; e0 += 4 * PART_THREADS) {
      float qv[4][4], gv[4][4], iv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * PART_THREADS;
        if (e < tile * w4) {
          const int row = t * tile + e / w4, c = c0 + 4 * (e % w4);
          load4(q + (size_t)row * a.ld + (size_t)h * C + c, qv[u]);
          load4(a.mean ? g + (size_t)row * C + c
                       : g + (size_t)row * hc + (size_t)h * C + c, gv[u]);
          iv[u] = a.inv[(size_t)row * heads + h];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * PART_THREADS;
        if (e < tile * w4) {
          const int i = e / w4, c = 4 * (e % w4);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            gv[u][x] = mm_round<T>((a.mean ? gv[u][x] * a.inv_heads : gv[u][x]) * iv[u]);
          store4(qs + (size_t)i * cc + c, qv[u]);
          store4(gsm + (size_t)i * cc + c, gv[u]);
        }
      }
    }
    __syncthreads();
    // PART_WCOLS columns per warp at a time: their pairs load together
    for (int w0 = warp; w0 < wcols; w0 += PART_WCOLS * NW) {
      float2 de[PART_WCOLS][MAX_GROUPS];
      unsigned bal[PART_WCOLS][MAX_GROUPS];
#pragma unroll
      for (int p = 0; p < PART_WCOLS; ++p) fetch(w0 + p * NW, de[p], bal[p]);
#pragma unroll
      for (int p = 0; p < PART_WCOLS; ++p) {
        const int w = w0 + p * NW;
        if (w >= wcols) break;
        float ak[4 * NGC], av[4 * NGC];
#pragma unroll
        for (int x = 0; x < 4 * NGC; ++x) ak[x] = av[x] = 0.f;
#pragma unroll
        for (int gi = 0; gi < MAX_GROUPS; ++gi) {
          unsigned b = bal[p][gi];
          while (b) {
            const int bit = __ffs(b) - 1;
            b &= b - 1u;
            const float dl = __shfl_sync(0xffffffffu, de[p][gi].x, bit);
            const float er = __shfl_sync(0xffffffffu, de[p][gi].y, bit);
            const T* qrow = qs + (size_t)(32 * gi + bit) * cc;
            const T* grow = gsm + (size_t)(32 * gi + bit) * cc;
#pragma unroll
            for (int gc = 0; gc < NGC; ++gc) {
              const int c = 4 * lane + 128 * gc;
              if (c < width) {
                float qv[4], gv[4];
                load4(qrow + c, qv);
                load4(grow + c, gv);
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                  ak[4 * gc + x] = fmaf(dl, qv[x], ak[4 * gc + x]);
                  av[4 * gc + x] = fmaf(er, gv[x], av[4 * gc + x]);
                }
              }
            }
          }
        }
        const size_t at = ((size_t)t * wcols + w) * hc + (size_t)h * C + c0;
#pragma unroll
        for (int gc = 0; gc < NGC; ++gc) {
          const int c = 4 * lane + 128 * gc;
          if (c < width) {
            store4(static_cast<T*>(a.dk) + at + c, &ak[4 * gc]);
            store4(static_cast<T*>(a.dv) + at + c, &av[4 * gc]);
          }
        }
      }
    }
    __syncthreads();   // the staged rows are rewritten for the next columns
  }
}

template <typename T, int MODE, int NG>
int run(const Args& a, cudaStream_t stream) {
  const size_t smem_rows = (size_t)ROWS_PER_BLOCK * a.wcols * 3 * sizeof(float);
  // stage all of C when it fits in two passes' worth (4 values per lane
  // per 128 columns), else 128 columns (or fewer) at a time
  const bool whole = a.C <= 2 * PART_CC && a.C > PART_CC
                     && parts_smem<T>(a.tile, a.C, a.wcols) <= PART_SMEM_MAX;
  int cc = whole ? a.C : (a.C < PART_CC ? a.C : PART_CC);
  while (cc > 4 && parts_smem<T>(a.tile, cc, a.wcols) > PART_SMEM_MAX) cc /= 2;
  const size_t smem_parts = parts_smem<T>(a.tile, cc, a.wcols);
  if (smem_rows > 48 * 1024 || smem_parts > PART_SMEM_MAX || a.wcols % 4)
    return (int)cudaErrorInvalidValue;
  tr_bwd_rows_kernel<T, MODE, NG><<<(a.n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                                    32 * ROWS_PER_BLOCK, smem_rows, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto parts = a.tile <= 128 ? (whole ? tr_bwd_parts_kernel<T, 4, 2> : tr_bwd_parts_kernel<T, 4, 1>)
                             : (whole ? tr_bwd_parts_kernel<T, 8, 2> : tr_bwd_parts_kernel<T, 8, 1>);
  err = cudaFuncSetAttribute(parts, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_parts);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.n_pad / a.tile, a.heads);
  parts<<<grid, PART_THREADS, smem_parts, stream>>>(a, cc);
  return (int)cudaGetLastError();
}

// C ≤ 128·NG: 4·NG values per lane
template <typename T, int MODE>
int dispatch_c(const Args& a, cudaStream_t stream) {
  if (a.C <= 128) return run<T, MODE, 1>(a, stream);
  if (a.C <= 256) return run<T, MODE, 2>(a, stream);
  if (a.C <= 512) return run<T, MODE, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const Args& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case PLAIN: return dispatch_c<T, PLAIN>(a, stream);
    case EDGE: return dispatch_c<T, EDGE>(a, stream);
    case GEO: return dispatch_c<T, GEO>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, qw, g, dq and the partials
// share it).  mode: 0 plain, 1 edge (feat [nt, edge_dim, T, Wcols]), 2 geo
// (feat [nt, 2, T, Wcols], pos [n_pad, 4]); qw [n_pad, heads·D] and dqw f32
// for modes 1 and 2; gs f32 [n_pad, heads·D] or null.  ld: the row stride of
// q, k and v.  mean: g is [n_pad, c] (every head receives g/H), else
// [n_pad, heads·c].  inv: the caller-allocated [n_pad, heads] f32 scratch;
// plane: the caller-allocated [n_pad / tile, heads, wcols, tile, 2] f32
// scratch (written and read only at the mask's nonzeros); dk, dv: [n_pad / tile, wcols,
// heads·c].  seed: device pointer to one int32, or null for no dropout.
// Returns the CUDA error code of the launches (0 on success).
int banded_transformer_bwd_launch(
    const int8_t* mask, const void* q, const void* k, const void* v,
    const float* feat, const float* pos, const void* qw, const void* g,
    const float* gs, float* inv, float* plane, void* dq, float* dqw, void* dk,
    void* dv, int n_pad, int ld, int heads, int c, int tile, int wcols,
    int mode, int edge_dim, int mean, int dtype, float scale, float inv_heads,
    const int* seed, unsigned int thresh, float inv_keep, void* stream) {
  const Args a{mask, q, k, v, ld, feat, pos, qw, g, gs, inv,
               reinterpret_cast<float2*>(plane), dq, dqw, dk, dv, n_pad,
               heads, c, tile, wcols, edge_dim, mean, scale, inv_heads,
               Drop{seed, thresh, inv_keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, mode, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, mode, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
