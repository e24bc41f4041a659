// Banded Transformer attention: plain, edge-conditioned and factorised
// geometric; head mean or concat; eval and training (attention dropout)
// forms; the fused-projection eval form; and the projection of the
// training path's q/k/v.
//
// Replaces two TPU kernels of gnn_bfs_rans_tpu/kernels/banded.py:
// banded_transformer_fwd (_transformer_kernel, every conditioning and head
// form, with and without dropout), entry banded_transformer_launch, and
// banded_transformer_geo_mean_fused (_transformer_kernel with fuse_proj,
// geo, mean_heads), entry banded_transformer_geo_mean_fused_launch.  For
// every receiver row i of tile t = i / T, each sender s_j = t·T −
// (Wcols−T)/2 + j whose int8 bias_noself entry is 1, and every head h:
//
//   l_j   = (q_i·k_j)·scale                                 scale = 1/√C (f32)
//         + Σ_d (qw_d·scale_q)·feat_d[i, j]                 edge form
//         + (qself − qd·pos_j)·invd[i, j] + qd_3·dist[i, j]  geo form,
//           qd = qw[i, h·4:(h+1)·4]·scale, qself = qd·pos_i
//   e_j   = exp(l_j − max l),   inv = 1 / max(Σ_j e_j, 1e-16)
//   ẽ_j   = e_j·keep_j/(1 − rate)                           dropout (else e_j)
//   out_h = inv · Σ_j round(ẽ_j) · v_j[h]                   (head mean: Σ_h / H)
//   s_h,d = inv · Σ_j ẽ_j · feat_d[i, j]                    edge form
//   s_h   = inv · (pos_i·Σ ẽ·invd − Σ ẽ·invd·pos_j, Σ ẽ·dist)  geo form
//
// with round() the cast of the probability to bf16 when q is bf16 (the TPU
// kernel's _mm_cast) and scale_q the scale in q's dtype (the product with
// qw stays f32, as XLA evaluates it).  The denominator is taken before the
// dropout, and the dropped ẽ feeds both the value product and s
// (_transformer_kernel's order).  keep_j is draw h of the hash stream
// seed + t at element i_local·Wcols + j (dropout.cuh), the JAX package's
// interpret-mode mask.  The geo form is computed in the TPU
// kernel's order: qself − qd·pos_j and pos_i·t0 − t13 cancel terms of size
// |pos|·invd into O(1) results, and a different grouping (pos_i − pos_j
// first) would compute another number than the reference.  A row with no
// sender (padding rows: bias_noself has no self-loops) writes out = s = 0,
// as the TPU kernel's −1e30 guard and 1e-16 clamp give.  Sender rows
// outside [0, n_pad) are never read (their mask entries are 0; the TPU
// kernel clamps onto duplicate blocks instead).
//
// The fused form projects q, k and v = x·W + b (f32 accumulate, the bias
// added in f32, one rounding to x's dtype) into one [N, 3·H·C] buffer in one
// launch of gemm_sm90.cuh's q/k/v projection (bf16: wgmma fed by TMA from
// the three weights as they are, output tiles of 128 rows × one head of q,
// k or v; f32: its SIMT tiles, true f32, no TF32), then runs the geo-mean
// attention with qw = q·wblk computed in the attention kernel in f32 (the
// TPU kernel keeps it f32).  Unlike the TPU kernel, q/k/v make one round
// trip through device memory (3·N·H·C·dtype bytes, 73.9 MB per layer at N
// 12,032, H·C 1,024 in bf16); keeping them on chip is later work.  The
// training path's projection (entry transformer_project_launch) is the
// shared gemm.cuh GEMM into the same buffer, then qw = q·wblk rounded to
// q's dtype, as banded_transformer_geo_mean_projgrad forms them outside its
// kernel.
//
// What bounds it on an H100: the attention is a sparse product.  The band
// mask holds ~4 senders per row of 256–640 columns; the TPU kernel computes
// the whole [T, Wcols] plane per head because its matrix unit has no
// gather.  Here one warp per receiver row compacts the row's mask to its
// nonzero columns (a ballot) and touches only those: 2·C operations per
// sender and head for the logit and 2·C for the value, ≈0.2 GFLOP at the
// flagship shape, far below the bytes it must move — q, k, v, the mask,
// out and s, each once, and the edge or geo planes at the mask's nonzeros
// only: ≈85 MB in bf16 geo form, ≈0.025 ms at 3.35 TB/s.  It is bound by
// bytes.  The fused form is bound by
// its projection, 3·2·N·F·H·C operations (18.9 GFLOP per layer, 19 µs at
// 989 TFLOP/s in bf16), about as much as it writes of q|k|v (73.9 MB, 22
// µs at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

// One warp per receiver row, 8 rows per block.  A lane covers 4 adjacent
// columns of a head in each of up to MAX_GROUPS groups of 128
// (4·lane + 128·g), read as one 8-byte (bf16) or 16-byte (f32) access; C
// must be a multiple of 4 and at most 512.  Per warp, shared memory holds
// the row's compacted window columns and their logits / probabilities.
constexpr int ROWS_PER_BLOCK = 8;
constexpr int MAX_GROUPS = 4;
constexpr int MAX_COLS = 4 * MAX_GROUPS;
constexpr int MAX_DE = 8;

enum Mode { PLAIN = 0, EDGE = 1, GEO = 2 };

using band::load4;
using band::mm_round;
using band::store4;
using band::to_f;
using band::warp_max;
using band::warp_sum;

// MODE: conditioning.  FUSED (geo only): qw is not given; ``qw`` points at
// wblk [H·C, H·4] and qw = q·wblk is formed here in f32.
template <typename T, int MODE, bool FUSED>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) transformer_kernel(
    const int8_t* __restrict__ mask,  // [n_tiles, T, Wcols]
    const T* __restrict__ q,          // row i at q + i·ld, heads h·C…
    const T* __restrict__ k,
    const T* __restrict__ v,
    int ld,
    const float* __restrict__ feat,   // EDGE [nt, D, T, Wc]; GEO [nt, 2, T, Wc]
    const float* __restrict__ pos,    // GEO [n_pad, 4]
    const T* __restrict__ qw,         // [n_pad, H·D] (FUSED: wblk [H·C, H·4])
    T* __restrict__ out,              // [n_pad, C] (mean) or [n_pad, H·C]
    float* __restrict__ s_out,        // [n_pad, H·D] f32 (EDGE, GEO)
    int n_pad, int heads, int C, int tile, int wcols, int edge_dim, int mean,
    float scale, Drop drop) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= n_pad) return;  // whole warp: no block-wide barrier below
  int* idx = reinterpret_cast<int*>(smem) + warp * 2 * wcols;
  float* pw = reinterpret_cast<float*>(idx + wcols);

  const int t = row / tile, r = row % tile;
  const int s0 = t * tile - (wcols - tile) / 2;
  const int8_t* mrow = mask + (size_t)row * wcols;

  // compact the mask row to its in-range nonzero window columns (in order)
  int cnt = 0;
  for (int base = 0; base < wcols; base += 32) {
    const int j = base + lane;
    const int s = s0 + j;
    const bool on = j < wcols && s >= 0 && s < n_pad && mrow[j] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (on) idx[cnt + __popc(bal & ((1u << lane) - 1u))] = j;
    cnt += __popc(bal);
  }
  __syncwarp();

  const int d_e = MODE == GEO ? 4 : MODE == EDGE ? edge_dim : 0;
  const size_t plane = (size_t)tile * wcols;
  // row r of receiver tile t in plane 0 of its conditioning planes
  const float* frow = MODE == PLAIN ? nullptr
                      : feat + (size_t)t * (MODE == GEO ? 2 : d_e) * plane
                            + (size_t)r * wcols;
  float pos_i[4] = {0.f, 0.f, 0.f, 0.f};
  if (MODE == GEO)
#pragma unroll
    for (int d = 0; d < 4; ++d) pos_i[d] = pos[(size_t)row * 4 + d];
  const float scale_q = mm_round<T>(scale);
  const int hc = heads * C;

  float total[MAX_COLS];
#pragma unroll
  for (int j = 0; j < MAX_COLS; ++j) total[j] = 0.f;

  for (int h = 0; h < heads; ++h) {
    float qv[MAX_COLS];
    const T* qrow = q + (size_t)row * ld + (size_t)h * C;
#pragma unroll
    for (int g = 0; g < MAX_GROUPS; ++g) {
      const int c = 4 * lane + 128 * g;
      if (c < C) {
        load4(qrow + c, &qv[4 * g]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qv[4 * g + e] = 0.f;
      }
    }
    // per-head conditioning coefficients
    float qe[MAX_DE];
    float qself = 0.f;
    if (MODE == EDGE) {
#pragma unroll
      for (int d = 0; d < MAX_DE; ++d)
        qe[d] = d < d_e ? to_f(qw[(size_t)row * heads * d_e + h * d_e + d]) * scale_q
                        : 0.f;
    }
    if (MODE == GEO) {
      float w4[4];
      if (FUSED) {
        // qw_h = q_h · wblk[h·C:(h+1)·C, h·4:(h+1)·4], f32
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int g = 0; g < MAX_GROUPS; ++g) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * lane + 128 * g + e;
            if (c < C) {
              float wv4[4];
              load4(qw + (size_t)(h * C + c) * (4 * heads) + 4 * h, wv4);
#pragma unroll
              for (int d = 0; d < 4; ++d) part[d] = fmaf(qv[4 * g + e], wv4[d], part[d]);
            }
          }
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) w4[d] = warp_sum(part[d]);
      } else {
#pragma unroll
        for (int d = 0; d < 4; ++d) w4[d] = to_f(qw[(size_t)row * heads * 4 + h * 4 + d]);
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) qe[d] = w4[d] * scale;
      qself = qe[0] * pos_i[0] + qe[1] * pos_i[1] + qe[2] * pos_i[2] + qe[3] * pos_i[3];
    }

    // logits at the compacted columns: a lane-split dot product, reduced
    float mx = -CUDART_INF_F;
    for (int kk = 0; kk < cnt; ++kk) {
      const int j = idx[kk];
      const int s = s0 + j;
      const T* krow = k + (size_t)s * ld + (size_t)h * C;
      float part = 0.f;
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g) {
        const int c = 4 * lane + 128 * g;
        if (c < C) {
          float kv[4];
          load4(krow + c, kv);
#pragma unroll
          for (int e = 0; e < 4; ++e) part = fmaf(qv[4 * g + e], kv[e], part);
        }
      }
      float l = warp_sum(part) * scale;
      if (MODE == EDGE) {
#pragma unroll
        for (int d = 0; d < MAX_DE; ++d)
          if (d < d_e) l += qe[d] * frow[d * plane + j];
      }
      if (MODE == GEO) {
        const float dist = frow[j], invd = frow[plane + j];
        const float* pj = pos + (size_t)s * 4;
        const float qpos = qe[0] * pj[0] + qe[1] * pj[1] + qe[2] * pj[2] + qe[3] * pj[3];
        l = l + (qself - qpos) * invd + qe[3] * dist;
      }
      if (lane == 0) pw[kk] = l;  // every lane holds the same l
      mx = fmaxf(mx, l);
    }
    __syncwarp();
    float sum = 0.f;
    for (int kk = lane; kk < cnt; kk += 32) {
      const float e = expf(pw[kk] - mx);
      sum += e;
      pw[kk] = e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.f / fmaxf(sum, 1e-16f);
    if (drop.seed != nullptr) {
      // the dropped ẽ replaces e in the value product and in s
      const uint32_t sv = (uint32_t)drop.seed[0] + (uint32_t)t;
      for (int kk = lane; kk < cnt; kk += 32) {
        const uint32_t flat = (uint32_t)r * (uint32_t)wcols + (uint32_t)idx[kk];
        pw[kk] = dropout_hash(sv, flat, (uint32_t)h) >= drop.thresh
                     ? pw[kk] * drop.inv_keep : 0.f;
      }
      __syncwarp();
    }

    float acc[MAX_COLS];
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) acc[j] = 0.f;
    for (int kk = 0; kk < cnt; ++kk) {
      const float p = mm_round<T>(pw[kk]);
      const T* vrow = v + (size_t)(s0 + idx[kk]) * ld + (size_t)h * C;
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g) {
        const int c = 4 * lane + 128 * g;
        if (c < C) {
          float vv[4];
          load4(vrow + c, vv);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * g + e] = fmaf(p, vv[e], acc[4 * g + e]);
        }
      }
    }
    if (mean) {
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) total[j] += acc[j] * inv;
    } else {
#pragma unroll
      for (int g = 0; g < MAX_GROUPS; ++g) {
        const int c = 4 * lane + 128 * g;
        if (c < C) {
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = acc[4 * g + e] * inv;
          store4(out + (size_t)row * hc + (size_t)h * C + c, o);
        }
      }
    }

    // s: the attention-weighted raw features, unrounded ẽ, lanes over senders
    if (MODE == EDGE) {
      float* srow = s_out + (size_t)row * heads * d_e + h * d_e;
      for (int d = 0; d < d_e; ++d) {
        float part = 0.f;
        for (int kk = lane; kk < cnt; kk += 32)
          part = fmaf(pw[kk], frow[d * plane + idx[kk]], part);
        part = warp_sum(part);
        if (lane == 0) srow[d] = part * inv;
      }
    }
    if (MODE == GEO) {
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f, s3 = 0.f;
      for (int kk = lane; kk < cnt; kk += 32) {
        const int j = idx[kk];
        const float e = pw[kk];
        const float ew = e * frow[plane + j];
        const float* pj = pos + (size_t)(s0 + j) * 4;
        t0 += ew;
        t1 = fmaf(ew, pj[0], t1);
        t2 = fmaf(ew, pj[1], t2);
        t3 = fmaf(ew, pj[2], t3);
        s3 = fmaf(e, frow[j], s3);
      }
      t0 = warp_sum(t0);
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      t3 = warp_sum(t3);
      s3 = warp_sum(s3);
      if (lane == 0) {
        float* srow = s_out + (size_t)row * heads * 4 + h * 4;
        srow[0] = (pos_i[0] * t0 - t1) * inv;
        srow[1] = (pos_i[1] * t0 - t2) * inv;
        srow[2] = (pos_i[2] * t0 - t3) * inv;
        srow[3] = s3 * inv;
      }
    }
    __syncwarp();  // pw is rewritten by the next head
  }

  if (mean) {
    const float inv_heads = 1.f / (float)heads;
#pragma unroll
    for (int g = 0; g < MAX_GROUPS; ++g) {
      const int c = 4 * lane + 128 * g;
      if (c < C) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = total[4 * g + e] * inv_heads;
        store4(out + (size_t)row * C + c, o);
      }
    }
  }
}

template <typename T, int MODE, bool FUSED>
int attention(const int8_t* mask, const void* q, const void* k, const void* v,
              int ld, const float* feat, const float* pos, const void* qw,
              void* out, float* s, int n_pad, int heads, int c, int tile,
              int wcols, int edge_dim, int mean, float scale, Drop drop,
              cudaStream_t stream) {
  const dim3 grid((n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const size_t smem = (size_t)ROWS_PER_BLOCK * wcols * (sizeof(int) + sizeof(float));
  transformer_kernel<T, MODE, FUSED><<<grid, 32 * ROWS_PER_BLOCK, smem, stream>>>(
      mask, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ld, feat, pos, static_cast<const T*>(qw),
      static_cast<T*>(out), s, n_pad, heads, c, tile, wcols, edge_dim, mean,
      scale, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const int8_t* mask, const void* q, const void* k, const void* v,
             int ld, const float* feat, const float* pos, const void* qw,
             void* out, float* s, int n_pad, int heads, int c, int tile,
             int wcols, int mode, int edge_dim, int mean, float scale,
             Drop drop, cudaStream_t stream) {
  switch (mode) {
    case PLAIN:
      return attention<T, PLAIN, false>(mask, q, k, v, ld, feat, pos, qw, out,
                                        s, n_pad, heads, c, tile, wcols,
                                        edge_dim, mean, scale, drop, stream);
    case EDGE:
      return attention<T, EDGE, false>(mask, q, k, v, ld, feat, pos, qw, out,
                                       s, n_pad, heads, c, tile, wcols,
                                       edge_dim, mean, scale, drop, stream);
    case GEO:
      return attention<T, GEO, false>(mask, q, k, v, ld, feat, pos, qw, out,
                                      s, n_pad, heads, c, tile, wcols,
                                      edge_dim, mean, scale, drop, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int fused(const int8_t* mask, const void* x, const void* wq, const void* wk,
          const void* wv, const void* bq, const void* bk, const void* bv,
          const void* wblk, const float* geo, const float* pos, void* qkv,
          void* out, float* s, int n_pad, int f, int heads, int c, int tile,
          int wcols, float scale, cudaStream_t stream) {
  const int hc = heads * c;
  T* base = static_cast<T*>(qkv);
  const T* const ws[3] = {static_cast<const T*>(wq), static_cast<const T*>(wk),
                          static_cast<const T*>(wv)};
  const T* const bs[3] = {static_cast<const T*>(bq), static_cast<const T*>(bk),
                          static_cast<const T*>(bv)};
  // qkv = x·[Wq | Wk | Wv] + [bq | bk | bv] (gemm_sm90.cuh): bf16 on
  // persistent blocks, f32 one block per tile
  cudaError_t err;
  if constexpr (sizeof(T) == 2)
    err = sm90::run_proj_fwd_bf16(static_cast<const T*>(x), ws, bs, base, n_pad,
                                  f, hc, stream);
  else
    err = sm90::f32::run_proj_fwd(static_cast<const T*>(x), ws, bs, base, n_pad,
                                  f, hc, stream);
  if (err != cudaSuccess) return (int)err;
  return attention<T, GEO, true>(mask, base, base + hc, base + 2 * hc, 3 * hc,
                                 geo, pos, wblk, out, s, n_pad, heads, c, tile,
                                 wcols, 4, 1, scale, Drop{nullptr, 0u, 1.f},
                                 stream);
}

template <typename T>
int project(const void* x, const void* w, const float* bias, const void* wblk,
            void* qkv, void* qw, int n_pad, int f, int heads, int c,
            cudaStream_t stream) {
  const int hc = heads * c;
  // qkv = x·[Wq | Wk | Wv] + [bq | bk | bv]: A = x [n_pad, F] K-contiguous,
  // B = W [F, 3·H·C] N-contiguous
  cudaError_t err = gemm::matmul(
      static_cast<const T*>(x), f, static_cast<const T*>(w), 3 * hc,
      static_cast<T*>(qkv), 3 * hc, n_pad, 3 * hc, f, stream, bias);
  if (err != cudaSuccess) return (int)err;
  // qw = q·wblk, rounded to q's dtype: A = q (row stride 3·H·C)
  return (int)gemm::matmul(
      static_cast<const T*>(qkv), 3 * hc, static_cast<const T*>(wblk),
      4 * heads, static_cast<T*>(qw), 4 * heads, n_pad, 4 * heads, hc,
      stream);
}

}  // namespace

extern "C" {

// Row 9.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, qw and out share it).
// mode: 0 plain, 1 edge (feat = [nt, edge_dim, T, Wcols]), 2 geo (feat =
// [nt, 2, T, Wcols], pos [n_pad, 4]); qw [n_pad, heads·D] and s [n_pad,
// heads·D] f32 for modes 1 and 2.  ld: the row stride of q, k and v.  mean:
// head mean (out [n_pad, c]) or concat (out [n_pad, heads·c]).  seed: device
// pointer to one int32, or null for no dropout.  Returns the CUDA error code
// of the launch (0 on success).
int banded_transformer_launch(const int8_t* mask, const void* q, const void* k,
                              const void* v, const float* feat,
                              const float* pos, const void* qw, void* out,
                              float* s, int n_pad, int ld, int heads, int c,
                              int tile, int wcols, int mode, int edge_dim,
                              int mean, int dtype, float scale,
                              const int* seed, unsigned int thresh,
                              float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drop drop{seed, thresh, inv_keep};
  if (dtype == 0)
    return dispatch<float>(mask, q, k, v, ld, feat, pos, qw, out, s, n_pad,
                           heads, c, tile, wcols, mode, edge_dim, mean, scale,
                           drop, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(mask, q, k, v, ld, feat, pos, qw, out, s,
                                   n_pad, heads, c, tile, wcols, mode,
                                   edge_dim, mean, scale, drop, st);
  return (int)cudaErrorInvalidValue;
}

// Row 11.  x [n_pad, f], wq/wk/wv [f, heads·c], bq/bk/bv [heads·c], wblk
// [heads·c, heads·4] in dtype (f and heads·c multiples of 8, every pointer
// 16-byte aligned); qkv the caller-allocated [n_pad, 3·heads·c] projection
// buffer; out [n_pad, c], s f32 [n_pad, heads·4].  Returns the CUDA error
// code of the launches.
int banded_transformer_geo_mean_fused_launch(
    const int8_t* mask, const void* x, const void* wq, const void* wk,
    const void* wv, const void* bq, const void* bk, const void* bv,
    const void* wblk, const float* geo, const float* pos, void* qkv,
    void* out, float* s, int n_pad, int f, int heads, int c, int tile,
    int wcols, int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fused<float>(mask, x, wq, wk, wv, bq, bk, bv, wblk, geo, pos, qkv,
                        out, s, n_pad, f, heads, c, tile, wcols, scale, st);
  if (dtype == 1)
    return fused<__nv_bfloat16>(mask, x, wq, wk, wv, bq, bk, bv, wblk, geo,
                                pos, qkv, out, s, n_pad, f, heads, c, tile,
                                wcols, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The training path's projection.  x [n_pad, f], w [f, 3·heads·c] (Wq | Wk
// | Wv), wblk [heads·c, heads·4] in dtype; bias f32 [3·heads·c]; qkv the
// caller-allocated [n_pad, 3·heads·c] output, qw [n_pad, heads·4] in dtype.
// Returns the CUDA error code of the launches.
int transformer_project_launch(const void* x, const void* w, const float* bias,
                               const void* wblk, void* qkv, void* qw,
                               int n_pad, int f, int heads, int c, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return project<float>(x, w, bias, wblk, qkv, qw, n_pad, f, heads, c, st);
  if (dtype == 1)
    return project<__nv_bfloat16>(x, w, bias, wblk, qkv, qw, n_pad, f, heads,
                                  c, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
