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
//     (warp ballot, as the forward), recomputes the logits and dp by warp
//     dot products, writes dq, dqw and the row statistics (max,
//     1/denominator, rs) per head: a small [N, 3H] f32 array;
//  2. tr_bwd_parts_kernel — one warp per (receiver tile, window column):
//     the tile's mask columns are staged in shared memory, the warp gathers
//     the column's receivers (a ballot), recomputes each one's logit and dp
//     with the same lane split as pass 1 (so the same e), and sums the
//     sender's dk and dv partial rows in registers, then rounds them once.
//
// What bounds it on an H100: bytes.  q, k, v and g are read (24.6 MB each
// at N 12,032, H·C 1,024 in bf16; g 6.2 MB in the head-mean form), dq
// written (24.6 MB) and the two partial arrays written (49.3 MB each at
// Wcols 256): ~200 MB, ~60 µs at 3.35 TB/s.  The arithmetic, 2·C
// operations per nonzero, head and product for the logit, dp, dq, dk and
// dv (the logit and dp twice), is ~0.5 GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 4;  // warps per block in the receiver pass
constexpr int PART_WARPS = 8;      // warps per block in the partials pass
constexpr int PART_COLS = 32;      // window columns per partials block
constexpr int MAX_GROUPS = 4;
constexpr int MAX_COLS = 4 * MAX_GROUPS;
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
  float* stats;         // [n_pad, 3H]: max | 1/denominator | rs
  void* dq;             // [n_pad, H·C]
  float* dqw;           // [n_pad, H·D]
  void* dk;             // [n_tiles, Wcols, H·C] partials
  void* dv;
  int n_pad, heads, C, tile, wcols, edge_dim, mean;
  float scale, inv_heads;
  Drop drop;
};

// a lane's columns 4·lane + 128·g … of one head's C values
template <typename T>
__device__ __forceinline__ void load_head(const T* row, int C, int lane,
                                          float v[MAX_COLS]) {
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const int c = 4 * lane + 128 * g;
    if (c < C) {
      load4(row + c, &v[4 * g]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * g + e] = 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_head(T* row, int C, int lane,
                                           const float v[MAX_COLS]) {
#pragma unroll
  for (int g = 0; g < MAX_GROUPS; ++g) {
    const int c = 4 * lane + 128 * g;
    if (c < C) store4(row + c, &v[4 * g]);
  }
}

// Σ_c a_c·b_c over the lanes' columns, in the forward kernel's order
__device__ __forceinline__ float dot_lanes(const float a[MAX_COLS],
                                           const float b[MAX_COLS]) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_COLS; ++j) part = fmaf(a[j], b[j], part);
  return warp_sum(part);
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

// the cotangent of head h at row i (the lane's columns, f32, unrounded)
template <typename T>
__device__ __forceinline__ void load_g(const Args& a, int row, int h,
                                       int lane, float graw[MAX_COLS]) {
  const T* g = static_cast<const T*>(a.g);
  load_head(a.mean ? g + (size_t)row * a.C
                   : g + (size_t)row * a.heads * a.C + (size_t)h * a.C,
            a.C, lane, graw);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) tr_bwd_rows_kernel(Args a) {
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
  const int d_e = MODE == GEO ? 4 : MODE == EDGE ? a.edge_dim : 0;
  const size_t plane = (size_t)tile * wcols;
  const float* frow = MODE == PLAIN ? nullptr
                      : a.feat + (size_t)t * (MODE == GEO ? 2 : d_e) * plane
                            + (size_t)r * wcols;
  const uint32_t sv = a.drop.seed != nullptr ? (uint32_t)a.drop.seed[0] + (uint32_t)t : 0u;
  const int hc = a.heads * C;

  for (int h = 0; h < a.heads; ++h) {
    float qv[MAX_COLS], gv[MAX_COLS];
    load_head(q + (size_t)row * a.ld + (size_t)h * C, C, lane, qv);
    load_g<T>(a, row, h, lane, gv);
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j)
      gv[j] = mm_round<T>(a.mean ? gv[j] * a.inv_heads : gv[j]);
    Cond<T, MODE> cond;
    cond.load(a, row, h);

    float mx = -CUDART_INF_F;
    for (int kk = 0; kk < cnt; ++kk) {
      const int j = idx[kk];
      const int s = s0 + j;
      const float* pj = MODE == GEO ? a.pos + (size_t)s * 4 : nullptr;
      float kv[MAX_COLS], vv[MAX_COLS];
      load_head(k + (size_t)s * a.ld + (size_t)h * C, C, lane, kv);
      load_head(v + (size_t)s * a.ld + (size_t)h * C, C, lane, vv);
      const float l = cond.logit(dot_lanes(qv, kv) * a.scale, a, frow, plane, j, pj);
      const float d = cond.dp(dot_lanes(gv, vv), a, frow, plane, j, pj);
      if (lane == 0) {
        el[kk] = l;
        dpv[kk] = d;
      }
      mx = fmaxf(mx, l);
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
      if (a.drop.seed != nullptr) {
        const uint32_t flat = (uint32_t)r * (uint32_t)wcols + (uint32_t)idx[kk];
        d = dropout_hash(sv, flat, (uint32_t)h) >= a.drop.thresh ? d * a.drop.inv_keep
                                                                 : 0.f;
      }
      dpv[kk] = d;
      s1 += el[kk] * d;
    }
    const float rs = warp_sum(s1) * inv;
    for (int kk = lane; kk < cnt; kk += 32)
      el[kk] = (el[kk] * ((dpv[kk] - rs) * inv)) * a.scale;   // dl
    __syncwarp();

    // dq = Σ round(dl)·k
    float acc[MAX_COLS];
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < cnt; ++kk) {
      const float dl = mm_round<T>(el[kk]);
      float kv[MAX_COLS];
      load_head(k + (size_t)(s0 + idx[kk]) * a.ld + (size_t)h * C, C, lane, kv);
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) acc[j] = fmaf(dl, kv[j], acc[j]);
    }
    store_head(static_cast<T*>(a.dq) + (size_t)row * hc + (size_t)h * C, C,
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
    if (lane == 0) {
      float* st = a.stats + (size_t)row * 3 * a.heads;
      st[h] = mx;
      st[a.heads + h] = inv;
      st[2 * a.heads + h] = rs;
    }
    __syncwarp();  // el, dpv are rewritten by the next head
  }
}

// One warp per window column w of receiver tile t (sender s = t·T − pad +
// w): its partial rows dk[t, w] and dv[t, w] over the tile's receivers of s.
template <typename T, int MODE>
__global__ void __launch_bounds__(32 * PART_WARPS) tr_bwd_parts_kernel(Args a) {
  extern __shared__ unsigned char smem[];
  const int tile = a.tile, wcols = a.wcols, C = a.C;
  const int t = blockIdx.y, c0 = blockIdx.x * PART_COLS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int8_t* ms = reinterpret_cast<int8_t*>(smem);                 // [T][PART_COLS]
  int* recv = reinterpret_cast<int*>(smem + (size_t)tile * PART_COLS) + warp * tile;
  const int8_t* mtile = a.mask + (size_t)t * tile * wcols;
  for (int e = threadIdx.x; e < tile * PART_COLS; e += blockDim.x) {
    const int i = e / PART_COLS, j = c0 + e % PART_COLS;
    ms[e] = j < wcols ? mtile[(size_t)i * wcols + j] : (int8_t)0;
  }
  __syncthreads();

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int pad = (wcols - tile) / 2;
  const int d_e = MODE == GEO ? 4 : MODE == EDGE ? a.edge_dim : 0;
  const size_t plane = (size_t)tile * wcols;
  const int hc = a.heads * C;
  const uint32_t sv = a.drop.seed != nullptr ? (uint32_t)a.drop.seed[0] + (uint32_t)t : 0u;

  for (int cc = warp; cc < PART_COLS; cc += PART_WARPS) {
    const int w = c0 + cc;
    if (w >= wcols) break;
    const int s = t * tile - pad + w;
    const bool in_range = s >= 0 && s < a.n_pad;
    int cnt = 0;
    for (int base = 0; base < tile; base += 32) {
      const int i = base + lane;
      const bool on = in_range && i < tile && ms[i * PART_COLS + cc] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) recv[cnt + __popc(bal & ((1u << lane) - 1u))] = i;
      cnt += __popc(bal);
    }
    __syncwarp();
    T* pk = static_cast<T*>(a.dk) + ((size_t)t * wcols + w) * hc;
    T* pv = static_cast<T*>(a.dv) + ((size_t)t * wcols + w) * hc;
    const float* pj = MODE == GEO && in_range ? a.pos + (size_t)s * 4 : nullptr;
    for (int h = 0; h < a.heads; ++h) {
      float acc_k[MAX_COLS], acc_v[MAX_COLS];
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) acc_k[j] = acc_v[j] = 0.f;
      if (cnt > 0) {
        float kv[MAX_COLS], vv[MAX_COLS];
        load_head(k + (size_t)s * a.ld + (size_t)h * C, C, lane, kv);
        load_head(v + (size_t)s * a.ld + (size_t)h * C, C, lane, vv);
        for (int n = 0; n < cnt; ++n) {
          const int i = recv[n];
          const int row = t * tile + i;
          const float* frow = MODE == PLAIN ? nullptr
                              : a.feat + (size_t)t * (MODE == GEO ? 2 : d_e) * plane
                                    + (size_t)i * wcols;
          float qv[MAX_COLS], graw[MAX_COLS];
          load_head(q + (size_t)row * a.ld + (size_t)h * C, C, lane, qv);
          load_g<T>(a, row, h, lane, graw);
          // round(g_h)·v in pass 1's order (dot_lanes)
          float pd = 0.f;
#pragma unroll
          for (int j = 0; j < MAX_COLS; ++j) {
            if (a.mean) graw[j] *= a.inv_heads;
            pd = fmaf(mm_round<T>(graw[j]), vv[j], pd);
          }
          Cond<T, MODE> cond;
          cond.load(a, row, h);
          const float l = cond.logit(dot_lanes(qv, kv) * a.scale, a, frow, plane, w, pj);
          float d = cond.dp(warp_sum(pd), a, frow, plane, w, pj);
          const float* st = a.stats + (size_t)row * 3 * a.heads;
          const float e = expf(l - st[h]);
          const float inv = st[a.heads + h];
          float ed = e;
          if (a.drop.seed != nullptr) {
            const bool keep = dropout_hash(sv, (uint32_t)i * (uint32_t)wcols + (uint32_t)w,
                                           (uint32_t)h) >= a.drop.thresh;
            ed = keep ? e * a.drop.inv_keep : 0.f;
            d = keep ? d * a.drop.inv_keep : 0.f;
          }
          const float dl = mm_round<T>((e * ((d - st[2 * a.heads + h]) * inv)) * a.scale);
          const float er = mm_round<T>(ed);
#pragma unroll
          for (int j = 0; j < MAX_COLS; ++j) {
            acc_k[j] = fmaf(dl, qv[j], acc_k[j]);
            acc_v[j] = fmaf(er, mm_round<T>(graw[j] * inv), acc_v[j]);
          }
        }
      }
      store_head(pk + (size_t)h * C, C, lane, acc_k);
      store_head(pv + (size_t)h * C, C, lane, acc_v);
    }
    __syncwarp();  // recv is rewritten for the next column
  }
}

template <typename T, int MODE>
int run(const Args& a, cudaStream_t stream) {
  const size_t smem_rows = (size_t)ROWS_PER_BLOCK * a.wcols * 3 * sizeof(float);
  const size_t smem_parts = (size_t)a.tile * PART_COLS
                            + (size_t)PART_WARPS * a.tile * sizeof(int);
  if (smem_rows > 48 * 1024 || smem_parts > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  tr_bwd_rows_kernel<T, MODE><<<(a.n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                                32 * ROWS_PER_BLOCK, smem_rows, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.wcols + PART_COLS - 1) / PART_COLS, a.n_pad / a.tile);
  tr_bwd_parts_kernel<T, MODE><<<grid, 32 * PART_WARPS, smem_parts, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int mode, cudaStream_t stream) {
  switch (mode) {
    case PLAIN: return run<T, PLAIN>(a, stream);
    case EDGE: return run<T, EDGE>(a, stream);
    case GEO: return run<T, GEO>(a, stream);
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
// [n_pad, heads·c].  stats: the caller-allocated [n_pad, 3·heads] f32
// scratch; dk, dv: [n_pad / tile, wcols, heads·c].  seed: device pointer to
// one int32, or null for no dropout.  Returns the CUDA error code of the
// launches (0 on success).
int banded_transformer_bwd_launch(
    const int8_t* mask, const void* q, const void* k, const void* v,
    const float* feat, const float* pos, const void* qw, const void* g,
    const float* gs, float* stats, void* dq, float* dqw, void* dk, void* dv,
    int n_pad, int ld, int heads, int c, int tile, int wcols, int mode,
    int edge_dim, int mean, int dtype, float scale, float inv_heads,
    const int* seed, unsigned int thresh, float inv_keep, void* stream) {
  const Args a{mask, q, k, v, ld, feat, pos, qw, g, gs, stats, dq, dqw, dk,
               dv, n_pad, heads, c, tile, wcols, edge_dim, mean, scale,
               inv_heads, Drop{seed, thresh, inv_keep}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, mode, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, mode, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
