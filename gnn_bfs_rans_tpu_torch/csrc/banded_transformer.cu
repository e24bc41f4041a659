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
// same gemm_sm90.cuh launch into the same buffer, with qw = q·wblk rounded
// to q's dtype, as banded_transformer_geo_mean_projgrad forms them outside
// its kernel: in bf16 from each staged q tile in the launch's epilogue on
// the tensor cores (C a multiple of 16 dividing its 256-column tile), else
// by qw_kernel over the written q (one thread per output, one ascending
// chain, wblk's diagonal blocks in shared memory).
//
// What bounds it on an H100: the attention is a sparse product.  The band
// mask holds ~4 senders per row of 256–640 columns; the TPU kernel computes
// the whole [T, Wcols] plane per head because its matrix unit has no
// gather.  Here each receiver row touches only its senders: 2·C operations
// per sender and head for the logit and 2·C for the value, ≈0.2 GFLOP at
// the flagship shape, far below the bytes it must move — q, k, v, the
// mask, out and s, each once, and the edge or geo planes at the mask's
// nonzeros only: ≈85 MB in bf16 geo form, ≈0.025 ms at 3.35 TB/s.  It is
// bound by bytes, and a row's time by load latency: a receiver gathers
// the k and v rows of its senders.  So one warp per receiver row compacts
// its mask row from 4-byte words by a warp prefix sum (senders in
// ascending window order), stages the head-independent conditioning of
// the compacted columns (dist, 1/dist and pos_j, or the edge features) in
// shared memory once, keeps the k chunks of several senders and all heads
// of a group in flight before it reduces any of them (all their dot
// products reduced together), forms every head's logits, softmax, dropout
// and s lane-parallel over senders, and gathers v the same way as k.  The
// fused form stages wblk's diagonal blocks in shared memory once per block
// and is bound by its projection, 3·2·N·F·H·C operations (18.9 GFLOP per
// layer, 19 µs at 989 TFLOP/s in bf16), about as much as it writes of
// q|k|v (73.9 MB, 22 µs at 3.35 TB/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "band_common.cuh"
#include "dropout.cuh"
#include "gemm_sm90.cuh"

namespace {

using band::Chunk;
using band::compact;
using band::load4;
using band::load_flags;
using band::load_row;
using band::mm_round;
using band::store4;
using band::to_f;
using band::warp_maxs;
using band::warp_sum;
using band::warp_sums;

// One warp per receiver row, up to MAX_WARPS rows per block (fewer when
// a row's shared memory does not fit that often): 4, so that blocks of
// 45 KB pack an SM four at a time at the flagship shape, and 8 in the
// fused form, whose block stages wblk first (4 rows a block there took
// 129 µs against 97 on the H100, kernels/rowtime.py).  Heads go in groups
// of HG, a head row's columns in blocks of CB, 8 a lane.  v and out move
// in V-column accesses (bf16: one 16-byte access, or two 8-byte ones when
// C or the row stride is not a multiple of 8; f32: two 16-byte ones); q
// and k in VK = 4-column ones (columns 4·lane + 128·g + e), so that each
// lane's part of a logit's dot product, and so each logit, is the one the
// kernel's earlier one-sender-at-a-time form computed, bit for bit.  A
// batch holds U = IN_FLIGHT / (HG·v accesses per head) senders (4 at the
// flagship: one batch for most rows of a 2-D mesh), whose k or v chunks
// of all the group's heads a lane loads before it uses any.  The form with one full group and one block (H 4, C ≤ 256, the
// flagship) is compiled with those counts fixed.
template <bool FUSED> constexpr int MAX_WARPS = FUSED ? 8 : 4;
template <bool FUSED> constexpr int MIN_BLOCKS = FUSED ? 2 : 4;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_WGROUPS = 6;  // a mask row: Wcols ≤ 768, in 128-byte groups
constexpr int MAX_DE = 8;
constexpr int HG = 4;
constexpr int CB = 256;
constexpr int IN_FLIGHT = 16;
constexpr int VK = 4;
constexpr int NCOEF = 10;       // per head: 8 coefficients, qself, 1/denominator

enum Mode { PLAIN = 0, EDGE = 1, GEO = 2 };

template <typename T>
struct TrArgs {
  const int8_t* mask;   // [n_tiles, T, Wcols]
  const T* q;           // row i at q + i·ld, heads h·C…
  const T* k;
  const T* v;
  const float* feat;    // EDGE [nt, D, T, Wc]; GEO [nt, 2, T, Wc]
  const float* pos;     // GEO [n_pad, 4]
  const T* qw;          // [n_pad, H·D] (FUSED: wblk [H·C, H·4])
  T* out;               // [n_pad, C] (mean) or [n_pad, H·C]
  float* s;             // [n_pad, H·D] f32 (EDGE, GEO)
  int ld, n_pad, heads, C, tile, wcols, edge_dim, mean;
  float scale;
  Drop drop;
};

// features staged per compacted column: GEO dist, invd, pos_j (4); EDGE
// the D edge features
template <int MODE>
__host__ __device__ constexpr int n_feat(int d_e) { return MODE == GEO ? 6 : MODE == EDGE ? d_e : 0; }

// 4-byte words of shared memory per warp: the compacted columns, the
// logits (then probabilities) of every head, the staged features, the
// per-head coefficients
__host__ __device__ inline int warp_words(int wcols, int heads, int nf) {
  return wcols * (1 + heads + nf) + heads * NCOEF;
}

// FUSED: wblk's columns per head in shared memory, C padded to whole
// spans of 32·VK (32 lanes × VK columns)
__host__ __device__ constexpr int fused_cols(int C) {
  return (C + 32 * VK - 1) / (32 * VK) * (32 * VK);
}

// MODE: conditioning.  FUSED (geo only): qw is not given; ``qw`` points at
// wblk [H·C, H·4], whose diagonal blocks the block stages in shared memory,
// and qw = q·wblk is formed here in f32.
template <typename T, int MODE, bool FUSED, int V, bool EXACT>
__global__ void __launch_bounds__(32 * MAX_WARPS<FUSED>, MIN_BLOCKS<FUSED>)
    transformer_kernel(const TrArgs<T> a) {
  using Ch = Chunk<T, V>;
  using R = typename Ch::raw;
  using ChK = Chunk<T, VK>;
  using RK = typename ChK::raw;
  constexpr int NG = CB / (32 * V), MC = V * NG;   // v and out
  constexpr int NGK = CB / (32 * VK);              // q and k: MC values too
  constexpr int U = IN_FLIGHT / (HG * NG) > 0 ? IN_FLIGHT / (HG * NG) : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int heads = EXACT ? HG : a.heads, C = a.C;
  const int blocks = EXACT ? 1 : (C + CB - 1) / CB;
  const int wcols = a.wcols, tile = a.tile;
  const int d_e = MODE == GEO ? 4 : MODE == EDGE ? a.edge_dim : 0;
  const int nf = n_feat<MODE>(d_e);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // FUSED: wblk's diagonal blocks, [H, wbc, 4]: wblk[h·C + c, 4·h + d]
  // for column c = 32·VK·span + VK·l + e of head h at slot 32·VK·span +
  // 32·e + l, so that lane l's reads of column VK·l + e are conflict-free
  float* wb = reinterpret_cast<float*>(smem);
  const int wbc = fused_cols(C);
  if (FUSED) {
    constexpr int PER = 4;   // rows of wblk a thread loads before it stores
    for (int i0 = 0; i0 < heads * C; i0 += PER * (int)blockDim.x) {
      float w4[PER][4];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = i0 + k * blockDim.x + threadIdx.x;
        if (i < heads * C) load4(a.qw + (size_t)i * 4 * heads + 4 * (i / C), w4[k]);
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = i0 + k * blockDim.x + threadIdx.x;
        if (i < heads * C) {
          const int h = i / C, c = i % C, w = c % (32 * VK);
          store4(wb + 4 * (h * wbc + (c - w) + 32 * (w % VK) + w / VK), w4[k]);
        }
      }
    }
    __syncthreads();
  }
  int* idx = reinterpret_cast<int*>(smem) + (FUSED ? 4 * heads * wbc : 0)
             + (size_t)warp * warp_words(wcols, heads, nf);
  float* lg = reinterpret_cast<float*>(idx + wcols);  // [heads][wcols]
  float* fs = lg + (size_t)heads * wcols;             // [nf][wcols]
  float* coef = fs + (size_t)nf * wcols;              // [heads][NCOEF]

  // one row a warp; FUSED: persistent blocks, whose warps walk the rows
  // so that one staging of wblk serves many of them (no block-wide
  // barrier below)
  for (int row = blockIdx.x * (blockDim.x / 32) + warp; row < a.n_pad;
       row += gridDim.x * (blockDim.x / 32)) {
    const int t = row / tile, r = row % tile;
    const int s0 = t * tile - (wcols - tile) / 2;
    // the mask row in 4-byte words, compacted to its in-range nonzero window
    // columns in ascending order by a warp prefix sum
    uint32_t mw[MAX_WGROUPS];
    load_flags<MAX_WGROUPS>(a.mask + (size_t)row * wcols, wcols, lane, mw);
    const int cnt = compact<MAX_WGROUPS>(
        mw, wcols, lane, idx, 0,
        [&](int j) { return s0 + j >= 0 && s0 + j < a.n_pad; },
        [](int j) { return j; });
    __syncwarp();

    // U senders' chunks of one head group and column block of k or v, all
    // loads issued before any is used (the batch's tail repeats its last
    // sender)
    auto sender = [&](int k0, int u) { return s0 + idx[k0 + u < cnt ? k0 + u : cnt - 1]; };
    auto load_k = [&](int hg0, int cb, int k0, RK (&buf)[U][HG][NGK]) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < HG; ++h)
          load_row<T, VK, NGK>(a.k + (size_t)sender(k0, u) * a.ld + (size_t)(hg0 + h) * C,
                               cb, C, lane, hg0 + h < heads, buf[u][h]);
    };
    auto load_v = [&](int hg0, int cb, int k0, R (&buf)[U][HG][NG]) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < HG; ++h)
          load_row<T, V, NG>(a.v + (size_t)sender(k0, u) * a.ld + (size_t)(hg0 + h) * C,
                             cb, C, lane, hg0 + h < heads, buf[u][h]);
    };
    auto load_q = [&](int hg0, int cb, RK (&qr)[HG][NGK]) {
#pragma unroll
      for (int h = 0; h < HG; ++h)
        load_row<T, VK, NGK>(a.q + (size_t)row * a.ld + (size_t)(hg0 + h) * C, cb, C, lane,
                             hg0 + h < heads, qr[h]);
    };

    // One round of loads before any is used: the first q chunks, the
    // head-independent conditioning of the first 32 compacted columns (lane
    // kk holds column kk's) and the per-head coefficients; then the staging
    // in shared memory, once per row (and the columns past 32 after it)
    RK qr[HG][NGK];
    load_q(0, 0, qr);
    const size_t plane = (size_t)tile * wcols;
    const float* frow = MODE == PLAIN ? nullptr
                        : a.feat + (size_t)t * (MODE == GEO ? 2 : d_e) * plane
                              + (size_t)r * wcols;
    float pos_i[4] = {0.f, 0.f, 0.f, 0.f};
    auto stage = [&](int kk) {   // column kk's features into fs
      const int j = idx[kk];
      if (MODE == GEO) {
        const float dist = frow[j], invd = frow[plane + j];
        const float4 pj = *reinterpret_cast<const float4*>(a.pos + (size_t)(s0 + j) * 4);
        fs[kk] = dist;
        fs[wcols + kk] = invd;
        fs[2 * wcols + kk] = pj.x;
        fs[3 * wcols + kk] = pj.y;
        fs[4 * wcols + kk] = pj.z;
        fs[5 * wcols + kk] = pj.w;
      }
      if (MODE == EDGE) {
        float f[MAX_DE];
#pragma unroll
        for (int d = 0; d < MAX_DE; ++d) f[d] = d < d_e ? frow[d * plane + j] : 0.f;
#pragma unroll
        for (int d = 0; d < MAX_DE; ++d)
          if (d < d_e) fs[d * wcols + kk] = f[d];
      }
    };
    // the coefficients: EDGE qw_d·scale_q, GEO qd = qw_h·scale (FUSED: from
    // q·wblk below)
    const int n_coef = MODE == PLAIN || FUSED ? 0 : heads * d_e;
    const float cscale = MODE == EDGE ? mm_round<T>(a.scale) : a.scale;
    auto coef_of = [&](int i) { return to_f(a.qw[(size_t)row * n_coef + i]) * cscale; };
    if (MODE != PLAIN) {
      if (MODE == GEO) {
        const float4 p = *reinterpret_cast<const float4*>(a.pos + (size_t)row * 4);
        pos_i[0] = p.x; pos_i[1] = p.y; pos_i[2] = p.z; pos_i[3] = p.w;
      }
      const float c0 = lane < n_coef ? coef_of(lane) : 0.f;
      if (lane < cnt) stage(lane);
      if (lane < n_coef) coef[(lane / d_e) * NCOEF + lane % d_e] = c0;
      for (int kk = lane + 32; kk < cnt; kk += 32) stage(kk);
      for (int i = lane + 32; i < n_coef; i += 32) coef[(i / d_e) * NCOEF + i % d_e] = coef_of(i);
    }
    // GEO: qself = qd·pos_i of each head
    auto geo_self = [&]() {
      __syncwarp();
      for (int h = lane; h < heads; h += 32) {
        float* cf = coef + h * NCOEF;
        cf[8] = cf[0] * pos_i[0] + cf[1] * pos_i[1] + cf[2] * pos_i[2] + cf[3] * pos_i[3];
      }
    };
    if (MODE == GEO && !FUSED) geo_self();

    // q·k at every (sender, head): per head group and column block, the q
    // chunks once, then U senders' k chunks of all the group's heads in
    // flight and their U·HG dot products reduced together, added to the
    // earlier blocks' in lg.  FUSED: each block's q·wblk partials reduced
    // before the k chunks are loaded, summed over the blocks in coef
    for (int hg0 = 0; hg0 < heads; hg0 += HG) {
      for (int b = 0; b < blocks; ++b) {
        const int cb = b * CB;
        if (hg0 > 0 || b > 0) load_q(hg0, cb, qr);
        float qf[HG][MC];
#pragma unroll
        for (int h = 0; h < HG; ++h)
#pragma unroll
          for (int gi = 0; gi < NGK; ++gi) ChK::unpack(qr[h][gi], &qf[h][VK * gi]);
        if (FUSED) {
          // wb holds head h's columns of each 32·VK span lane-interleaved:
          // lane l's column VK·l + e at slot 32·e + l, conflict-free
          float qwp[4 * HG];
#pragma unroll
          for (int i = 0; i < 4 * HG; ++i) qwp[i] = 0.f;
#pragma unroll
          for (int h = 0; h < HG; ++h)
#pragma unroll
            for (int gi = 0; gi < NGK; ++gi)
#pragma unroll
              for (int e = 0; e < VK; ++e) {
                const int c = cb + VK * lane + 32 * VK * gi + e;
                if (hg0 + h < heads && c < C) {
                  const float4 w = *reinterpret_cast<const float4*>(
                      wb + 4 * ((hg0 + h) * wbc + cb + 32 * VK * gi + 32 * e + lane));
                  const float x = qf[h][VK * gi + e];
                  qwp[4 * h] = fmaf(x, w.x, qwp[4 * h]);
                  qwp[4 * h + 1] = fmaf(x, w.y, qwp[4 * h + 1]);
                  qwp[4 * h + 2] = fmaf(x, w.z, qwp[4 * h + 2]);
                  qwp[4 * h + 3] = fmaf(x, w.w, qwp[4 * h + 3]);
                }
              }
          warp_sums<4 * HG>(qwp);
#pragma unroll
          for (int i = 0; i < 4 * HG; ++i)
            if (lane == i && hg0 + i / 4 < heads) {
              float* d = coef + (hg0 + i / 4) * NCOEF + i % 4;
              *d = b == 0 ? qwp[i] : *d + qwp[i];
            }
        }
        RK kb[U][HG][NGK];
        for (int k0 = 0; k0 < cnt; k0 += U) {
          load_k(hg0, cb, k0, kb);
          float p[U * HG];
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int h = 0; h < HG; ++h) {
              float part = 0.f;
#pragma unroll
              for (int gi = 0; gi < NGK; ++gi) {
                float kv[VK];
                ChK::unpack(kb[u][h][gi], kv);
#pragma unroll
                for (int e = 0; e < VK; ++e) part = fmaf(qf[h][VK * gi + e], kv[e], part);
              }
              p[u * HG + h] = part;
            }
          warp_sums<U * HG>(p);
#pragma unroll
          for (int i = 0; i < U * HG; ++i) {
            const int k = k0 + i / HG, h = hg0 + i % HG;
            if (lane == i && k < cnt && h < heads) {
              float* d = lg + h * wcols + k;
              *d = b == 0 ? p[i] : *d + p[i];
            }
          }
        }
      }
    }
    if (FUSED) {
      __syncwarp();
      for (int i = lane; i < heads * 4; i += 32) coef[(i / 4) * NCOEF + i % 4] *= a.scale;
      geo_self();
    }
    __syncwarp();

    // per head group, lanes over senders: the logits from the dot products
    // and the staged conditioning, the softmax, the dropout, s
    const uint32_t sv = a.drop.seed != nullptr ? (uint32_t)a.drop.seed[0] + (uint32_t)t : 0u;
    for (int hg0 = 0; hg0 < heads; hg0 += HG) {
      float mx[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) mx[h] = -CUDART_INF_F;
      for (int kk = lane; kk < cnt; kk += 32) {
        float dist = 0.f, invd = 0.f, pj[4] = {0.f, 0.f, 0.f, 0.f};
        if (MODE == GEO) {
          dist = fs[kk];
          invd = fs[wcols + kk];
#pragma unroll
          for (int d = 0; d < 4; ++d) pj[d] = fs[(2 + d) * wcols + kk];
        }
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          if (hg0 + h >= heads) continue;
          const float* cf = coef + (hg0 + h) * NCOEF;
          float* lp = lg + (hg0 + h) * wcols + kk;
          float l = *lp * a.scale;
          if (MODE == EDGE) {
#pragma unroll
            for (int d = 0; d < MAX_DE; ++d)
              if (d < d_e) l += cf[d] * fs[d * wcols + kk];
          }
          if (MODE == GEO) {
            const float qpos = cf[0] * pj[0] + cf[1] * pj[1] + cf[2] * pj[2] + cf[3] * pj[3];
            l = l + (cf[8] - qpos) * invd + cf[3] * dist;
          }
          *lp = l;
          mx[h] = fmaxf(mx[h], l);
        }
      }
      warp_maxs<HG>(mx);
      float sum[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) sum[h] = 0.f;
      for (int kk = lane; kk < cnt; kk += 32)
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          if (hg0 + h >= heads) continue;
          float* lp = lg + (hg0 + h) * wcols + kk;
          const float e = expf(*lp - mx[h]);
          sum[h] += e;
          *lp = e;
        }
      warp_sums<HG>(sum);
      float inv[HG];
#pragma unroll
      for (int h = 0; h < HG; ++h) inv[h] = 1.f / fmaxf(sum[h], 1e-16f);
      if (a.drop.seed != nullptr) {
        // the dropped ẽ replaces e in the value product and in s
        for (int kk = lane; kk < cnt; kk += 32) {
          const uint32_t flat = (uint32_t)r * (uint32_t)wcols + (uint32_t)idx[kk];
#pragma unroll
          for (int h = 0; h < HG; ++h) {
            if (hg0 + h >= heads) continue;
            float* lp = lg + (hg0 + h) * wcols + kk;
            *lp = dropout_hash(sv, flat, (uint32_t)(hg0 + h)) >= a.drop.thresh
                      ? *lp * a.drop.inv_keep : 0.f;
          }
        }
      }
      if (lane == 0)
#pragma unroll
        for (int h = 0; h < HG; ++h)
          if (hg0 + h < heads) coef[(hg0 + h) * NCOEF + 9] = inv[h];

      // s: the attention-weighted raw features, unrounded ẽ
      if (MODE == GEO) {
        // t0 = Σẽ·invd, t1..3 = Σẽ·invd·pos_j, s3 = Σẽ·dist of each head
        float ts[5 * HG];
#pragma unroll
        for (int i = 0; i < 5 * HG; ++i) ts[i] = 0.f;
        for (int kk = lane; kk < cnt; kk += 32) {
          const float dist = fs[kk], invd = fs[wcols + kk];
          const float p0 = fs[2 * wcols + kk], p1 = fs[3 * wcols + kk], p2 = fs[4 * wcols + kk];
#pragma unroll
          for (int h = 0; h < HG; ++h) {
            if (hg0 + h >= heads) continue;
            const float e = lg[(hg0 + h) * wcols + kk];
            const float ew = e * invd;
            float* tt = ts + 5 * h;
            tt[0] += ew;
            tt[1] = fmaf(ew, p0, tt[1]);
            tt[2] = fmaf(ew, p1, tt[2]);
            tt[3] = fmaf(ew, p2, tt[3]);
            tt[4] = fmaf(e, dist, tt[4]);
          }
        }
        warp_sums<5 * HG>(ts);
        if (lane == 0)
#pragma unroll
          for (int h = 0; h < HG; ++h) {
            if (hg0 + h >= heads) continue;
            const float* tt = ts + 5 * h;
            float* srow = a.s + (size_t)row * heads * 4 + (hg0 + h) * 4;
            srow[0] = (pos_i[0] * tt[0] - tt[1]) * inv[h];
            srow[1] = (pos_i[1] * tt[0] - tt[2]) * inv[h];
            srow[2] = (pos_i[2] * tt[0] - tt[3]) * inv[h];
            srow[3] = tt[4] * inv[h];
          }
      }
      if (MODE == EDGE) {
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          if (hg0 + h >= heads) continue;
          float* srow = a.s + (size_t)row * heads * d_e + (hg0 + h) * d_e;
          for (int d = 0; d < d_e; ++d) {
            float part = 0.f;
            for (int kk = lane; kk < cnt; kk += 32)
              part = fmaf(lg[(hg0 + h) * wcols + kk], fs[d * wcols + kk], part);
            part = warp_sum(part);
            if (lane == 0) srow[d] = part * inv[h];
          }
        }
      }
    }
    __syncwarp();

    // out: per column block and head group, U senders' v chunks of all the
    // group's heads in flight, summed in ascending sender order with
    // round(ẽ); the head mean sums the heads in order
    const int hc = heads * C;
    const float inv_heads = 1.f / (float)heads;
    for (int b = 0; b < blocks; ++b) {
      const int cb = b * CB;
      float total[MC];
#pragma unroll
      for (int e = 0; e < MC; ++e) total[e] = 0.f;
      for (int hg0 = 0; hg0 < heads; hg0 += HG) {
        float acc[HG][MC];
#pragma unroll
        for (int h = 0; h < HG; ++h)
#pragma unroll
          for (int e = 0; e < MC; ++e) acc[h][e] = 0.f;
        R vb[U][HG][NG];
        for (int k0 = 0; k0 < cnt; k0 += U) {
          load_v(hg0, cb, k0, vb);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (k0 + u >= cnt) break;
#pragma unroll
            for (int h = 0; h < HG; ++h) {
              const float p = hg0 + h < heads ? mm_round<T>(lg[(hg0 + h) * wcols + k0 + u]) : 0.f;
#pragma unroll
              for (int gi = 0; gi < NG; ++gi) {
                float vv[V];
                Ch::unpack(vb[u][h][gi], vv);
#pragma unroll
                for (int e = 0; e < V; ++e)
                  acc[h][V * gi + e] = fmaf(p, vv[e], acc[h][V * gi + e]);
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < HG; ++h) {
          if (hg0 + h >= heads) continue;
          const float iv = coef[(hg0 + h) * NCOEF + 9];
          if (a.mean) {
#pragma unroll
            for (int e = 0; e < MC; ++e) total[e] += acc[h][e] * iv;
          } else {
#pragma unroll
            for (int gi = 0; gi < NG; ++gi) {
              const int c = cb + V * lane + 32 * V * gi;
              if (c < C) {
                float o[V];
#pragma unroll
                for (int e = 0; e < V; ++e) o[e] = acc[h][V * gi + e] * iv;
                *reinterpret_cast<R*>(a.out + (size_t)row * hc + (size_t)(hg0 + h) * C + c) =
                    Ch::pack(o);
              }
            }
          }
        }
      }
      if (a.mean) {
#pragma unroll
        for (int gi = 0; gi < NG; ++gi) {
          const int c = cb + V * lane + 32 * V * gi;
          if (c < C) {
            float o[V];
#pragma unroll
            for (int e = 0; e < V; ++e) o[e] = total[V * gi + e] * inv_heads;
            *reinterpret_cast<R*>(a.out + (size_t)row * C + c) = Ch::pack(o);
          }
        }
      }
    }
    if (!FUSED) break;   // one row a warp: no loop for the compiler to carry
    __syncwarp();  // the warp's next row rewrites its shared memory
  }
}

template <typename T, int MODE, bool FUSED, int V, bool EXACT>
int run(const TrArgs<T>& a, cudaStream_t stream) {
  const int nf = n_feat<MODE>(MODE == GEO ? 4 : a.edge_dim);
  const size_t fixed = FUSED ? (size_t)16 * a.heads * fused_cols(a.C) : 0;
  const size_t per_warp = (size_t)4 * warp_words(a.wcols, a.heads, nf);
  if (a.heads < 1 || a.wcols % 4 || a.wcols > 128 * MAX_WGROUPS
      || fixed + per_warp > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)SMEM_MAX - fixed) / per_warp;
  const int warps = fit < (size_t)MAX_WARPS<FUSED> ? (int)fit : MAX_WARPS<FUSED>;
  const size_t smem = fixed + (size_t)warps * per_warp;
  auto kernel = transformer_kernel<T, MODE, FUSED, V, EXACT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int grid = (a.n_pad + warps - 1) / warps;
  if (FUSED) {   // MIN_BLOCKS resident blocks per SM walk the rows
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid = grid < MIN_BLOCKS<FUSED> * sms ? grid : MIN_BLOCKS<FUSED> * sms;
  }
  kernel<<<grid, 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// 16-byte accesses, or 8-byte ones for a bf16 C or row stride that is not
// a multiple of 8; the fixed-count form when the heads fill one group and
// C one block
template <typename T, int MODE, bool FUSED>
int attention(const TrArgs<T>& a, cudaStream_t stream) {
  const bool exact = a.heads == HG && a.C <= CB;
  if constexpr (sizeof(T) == 2) {
    if (a.C % 8 || a.ld % 8) return run<T, MODE, FUSED, 4, false>(a, stream);
    return exact ? run<T, MODE, FUSED, 8, true>(a, stream)
                 : run<T, MODE, FUSED, 8, false>(a, stream);
  } else {
    return exact ? run<T, MODE, FUSED, 4, true>(a, stream)
                 : run<T, MODE, FUSED, 4, false>(a, stream);
  }
}

template <typename T>
int dispatch(const int8_t* mask, const void* q, const void* k, const void* v,
             int ld, const float* feat, const float* pos, const void* qw,
             void* out, float* s, int n_pad, int heads, int c, int tile,
             int wcols, int mode, int edge_dim, int mean, float scale,
             Drop drop, cudaStream_t stream) {
  const TrArgs<T> a{mask, static_cast<const T*>(q), static_cast<const T*>(k),
                    static_cast<const T*>(v), feat, pos,
                    static_cast<const T*>(qw), static_cast<T*>(out), s, ld,
                    n_pad, heads, c, tile, wcols, edge_dim, mean, scale, drop};
  switch (mode) {
    case PLAIN: return attention<T, PLAIN, false>(a, stream);
    case EDGE: return attention<T, EDGE, false>(a, stream);
    case GEO: return attention<T, GEO, false>(a, stream);
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
    err = sm90::run_proj_fwd_bf16(static_cast<const T*>(x), ws, bs, 3, base,
                                  n_pad, f, hc, stream);
  else
    err = sm90::f32::run_proj_fwd(static_cast<const T*>(x), ws, bs, 3, base,
                                  n_pad, f, hc, stream);
  if (err != cudaSuccess) return (int)err;
  const TrArgs<T> a{mask, base, base + hc, base + 2 * hc, geo, pos,
                    static_cast<const T*>(wblk), static_cast<T*>(out), s,
                    3 * hc, n_pad, heads, c, tile, wcols, 4, 1, scale,
                    Drop{nullptr, 0u, 1.f}};
  return attention<T, GEO, true>(a, stream);
}

// qw[row, 4h + d] = Σ_k q[row, hC + k]·wblk[hC + k, 4h + d], rounded to
// T: one thread per output, k ascending in one chain of fused multiply-adds
// (the order of a plain f32 product over the block-diagonal wblk, whose
// off-diagonal zeros add nothing, so f32 gives its bits); wblk's diagonal
// blocks staged once a block in shared memory as f32, head h at h·(4C + 8)
// + 4k + d (the pad puts a warp's 16 (head, d) pairs on distinct banks);
// q the first H·C columns of qkv (row stride 3·H·C)
template <typename T>
__global__ void __launch_bounds__(256) qw_kernel(const T* __restrict__ qkv,
                                                 const T* __restrict__ wblk,
                                                 T* __restrict__ qw, int n,
                                                 int heads, int c) {
  extern __shared__ float wd[];
  const int hc = heads * c, per = 4 * c + 8, outs = 4 * heads;
#pragma unroll 4
  for (int i = threadIdx.x; i < 4 * hc; i += blockDim.x) {
    const int col = i / 4, d = i % 4, h = col / c;
    wd[h * per + 4 * (col % c) + d] = to_f(wblk[(size_t)col * outs + 4 * h + d]);
  }
  __syncthreads();
  const long long total = (long long)n * outs;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(t / outs), j = (int)(t % outs), h = j / 4;
    const T* q = qkv + (size_t)row * 3 * hc + (size_t)h * c;
    const float* w = wd + h * per + j % 4;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < c; ++k) s = fmaf(to_f(q[k]), w[4 * k], s);
    qw[t] = band::from_f<T>(s);
  }
}

template <typename T>
int project(const void* x, const void* wq, const void* wk, const void* wv,
            const void* bq, const void* bk, const void* bv, const void* wblk,
            void* qkv, void* qw, int n_pad, int f, int heads, int c,
            cudaStream_t stream) {
  const int hc = heads * c;
  T* out = static_cast<T*>(qkv);
  const T* const ws[3] = {static_cast<const T*>(wq), static_cast<const T*>(wk),
                          static_cast<const T*>(wv)};
  const T* const bs[3] = {static_cast<const T*>(bq), static_cast<const T*>(bk),
                          static_cast<const T*>(bv)};
  // qkv = x·[Wq | Wk | Wv] + [bq | bk | bv] (gemm_sm90.cuh, as row 11's);
  // bf16 forms qw in the q tiles' epilogue where it can
  bool done = false;
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    done = sm90::fwd::qw_in_epilogue(hc, c);
    err = sm90::run_proj_fwd_bf16(static_cast<const T*>(x), ws, bs, 3, out,
                                  n_pad, f, hc, stream,
                                  done ? static_cast<T*>(qw) : nullptr,
                                  static_cast<const T*>(wblk), c);
  } else {
    err = sm90::f32::run_proj_fwd(static_cast<const T*>(x), ws, bs, 3, out,
                                  n_pad, f, hc, stream);
  }
  if (err != cudaSuccess || done) return (int)err;
  // persistent blocks, eight a SM, each staging wblk's diagonal blocks once
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = sizeof(float) * (size_t)heads * (4 * c + 8);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)n_pad * 4 * heads + 255) / 256;
  qw_kernel<T><<<(int)(blocks < 8 * sms ? blocks : 8 * sms), 256, smem, stream>>>(
      out, static_cast<const T*>(wblk), static_cast<T*>(qw), n_pad, heads, c);
  return (int)cudaGetLastError();
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

// The training path's projection.  x [n_pad, f], wq/wk/wv [f, heads·c],
// bq/bk/bv [heads·c] and wblk [heads·c, heads·4] (only its diagonal head
// blocks are read: qw[:, 4h + d] = q_h·wblk[hC:(h + 1)C, 4h + d]) in dtype
// (f and heads·c multiples of 16 bytes' worth of elements, every pointer
// 16-byte aligned); qkv the caller-allocated [n_pad, 3·heads·c] output, qw
// [n_pad, heads·4] in dtype.  qw is formed in the q tiles' epilogue where
// it can (bf16, C a multiple of 16 dividing 256), else by qw_kernel.
// Returns the CUDA error code of the launches.
int transformer_project_launch(const void* x, const void* wq, const void* wk,
                               const void* wv, const void* bq, const void* bk,
                               const void* bv, const void* wblk, void* qkv,
                               void* qw, int n_pad, int f, int heads, int c,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return project<float>(x, wq, wk, wv, bq, bk, bv, wblk, qkv, qw, n_pad, f,
                          heads, c, st);
  if (dtype == 1)
    return project<__nv_bfloat16>(x, wq, wk, wv, bq, bk, bv, wblk, qkv, qw,
                                  n_pad, f, heads, c, st);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
