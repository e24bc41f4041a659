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
// GFLOP per layer at N 12,032, F 256, H 4, C 256), is the only dense work:
// 6.4 µs at 989 TFLOP/s in bf16, about as long as writing z (24.6 MB, 7.3
// µs at 3.35 TB/s).  It runs on gemm_sm90.cuh's forward projection with one
// weight and no bias: in bf16 persistent blocks, TMA-fed m64n256 wgmmas,
// tiles staged in shared memory and written by TMA stores; in f32 its SIMT
// tiles in true f32 FMA (no TF32, the TPU kernel's Precision.HIGHEST).  z
// makes one round trip through device memory.  The attention
// is a sparse product: the band mask holds ~5 entries per row of 256–640
// columns, so the work this data needs is 2·nnz·H·C operations, far below
// the bytes it moves (z, α, the mask, out: 34.3 MB per layer at the
// flagship shape in bf16 for the head mean, 52.7 MB for concat), and a
// row's time is load latency: each receiver gathers the z rows of its
// senders.  One warp per receiver row compacts the mask row from 4-byte
// words by a warp prefix sum (no serial scan), loads each sender's source
// α of a head group at once (one 16-byte load at H 4), forms the logits
// of all heads lane-parallel over senders, and then keeps the z chunks of
// several senders and all heads of a group in flight (16-byte loads)
// before it sums any of them; the dense [T, Wcols] plane of the TPU kernel
// is never formed.  Row 4 has no projection and runs the attention alone.

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
using band::load_flags;
using band::load_row;
using band::mm_round;
using band::warp_maxs;
using band::warp_sums;

// ----------------------------------------------------------------- attention
// One warp per receiver row, up to MAX_WARPS rows per block (fewer when a
// row's shared memory does not fit that often).  Heads go in groups of
// HG, a head row's columns in blocks of CB (8 a lane in bf16: one 16-byte
// access; 4 a lane twice in f32, and in bf16 when C is not a multiple of
// 8); each lane keeps IN_FLIGHT such accesses of z in flight, so a batch
// holds U = IN_FLIGHT / (HG·accesses per head) senders (2 at the
// flagship).  The launch bounds hold a thread to 80 registers, so that
// MIN_BLOCKS blocks (24 warps) share an SM: more rows in flight beat more
// senders per row (on the H100, 16 accesses a lane at 128 registers and
// 16 warps took 30.9 µs against 24.2 at the flagship shape,
// kernels/rowtime.py).  The form with one full group
// and one block (H 4, C ≤ 256, the flagship) is compiled with those
// counts fixed.
constexpr int MAX_WARPS = 4;
constexpr int MIN_BLOCKS = 6;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int MAX_WGROUPS = 6;  // a mask row: Wcols ≤ 768, in 128-byte groups
constexpr int HG = 4;
constexpr int CB = 256;
constexpr int IN_FLIGHT = 8;

template <typename T>
struct GatArgs {
  const int8_t* mask;    // [n_tiles, T, Wcols]
  const float* alphas;   // [n_pad, 2H]: src | dst
  const T* z;            // [n_pad, H·C]
  T* out;                // [n_pad, C], or [n_pad, H·C] (CONCAT)
  int n_pad, heads, C, tile, wcols;
  float slope;
  Drop drop;
};

// 4-byte words of shared memory per warp: the compacted window columns,
// the probabilities of every head, the 1/denominators
__host__ __device__ inline int gat_words(int wcols, int heads) {
  return wcols * (1 + heads) + heads;
}

// CONCAT: each head's output written to its own C columns (row 4's concat
// form); else the head mean.
template <typename T, int V, bool EXACT, bool CONCAT>
__global__ void __launch_bounds__(32 * MAX_WARPS, MIN_BLOCKS)
    gat_attention_kernel(const GatArgs<T> a) {
  using Ch = Chunk<T, V>;
  using R = typename Ch::raw;
  constexpr int NG = CB / (32 * V), MC = V * NG;
  constexpr int U = IN_FLIGHT / (HG * NG) > 0 ? IN_FLIGHT / (HG * NG) : 1;
  extern __shared__ unsigned char smem[];
  const int heads = EXACT ? HG : a.heads, C = a.C;
  const int blocks = EXACT ? 1 : (C + CB - 1) / CB;
  const int wcols = a.wcols, tile = a.tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= a.n_pad) return;  // whole warp: no block-wide barrier below
  int* idx = reinterpret_cast<int*>(smem) + (size_t)warp * gat_words(wcols, heads);
  float* pw = reinterpret_cast<float*>(idx + wcols);  // [heads][wcols]
  float* invs = pw + (size_t)heads * wcols;           // [heads]

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

  // U senders' z chunks of one head group and column block, all loads
  // issued before any is used (the batch's tail repeats its last sender)
  const int hc = heads * C;
  auto load_batch = [&](int hg0, int cb, int k0, R (&buf)[U][HG][NG]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int s = s0 + idx[k0 + u < cnt ? k0 + u : cnt - 1];
#pragma unroll
      for (int h = 0; h < HG; ++h)
        load_row<T, V, NG>(a.z + (size_t)s * hc + (size_t)(hg0 + h) * C, cb, C, lane,
                           hg0 + h < heads, buf[u][h]);
    }
  };

  // per head group, lanes over senders: the logits of every head from one
  // load of the sender's source α, the softmax, the dropout (stream seed +
  // t over tile t's [H·T, Wcols] plane), round(ẽ)
  const int two_h = 2 * heads;
  const uint32_t sv = a.drop.seed != nullptr ? (uint32_t)a.drop.seed[0] + (uint32_t)t : 0u;
  for (int hg0 = 0; hg0 < heads; hg0 += HG) {
    float ad[HG], mx[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) {
      ad[h] = hg0 + h < heads ? a.alphas[(size_t)row * two_h + heads + hg0 + h] : 0.f;
      mx[h] = -CUDART_INF_F;
    }
    for (int kk = lane; kk < cnt; kk += 32) {
      const float* as = a.alphas + (size_t)(s0 + idx[kk]) * two_h + hg0;
      float src[HG];
      if (EXACT) {
        const float4 v4 = *reinterpret_cast<const float4*>(as);
        src[0] = v4.x; src[1] = v4.y; src[2] = v4.z; src[3] = v4.w;
      } else {
#pragma unroll
        for (int h = 0; h < HG; ++h) src[h] = hg0 + h < heads ? as[h] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        if (hg0 + h >= heads) continue;
        float l = ad[h] + src[h];
        l = l >= 0.f ? l : a.slope * l;
        pw[(hg0 + h) * wcols + kk] = l;
        mx[h] = fmaxf(mx[h], l);
      }
    }
    warp_maxs<HG>(mx);
    float sum[HG];
#pragma unroll
    for (int h = 0; h < HG; ++h) sum[h] = 0.f;
    for (int kk = lane; kk < cnt; kk += 32) {
      const uint32_t j = (uint32_t)idx[kk];
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        if (hg0 + h >= heads) continue;
        float* pp = pw + (hg0 + h) * wcols + kk;
        const float e = expf(*pp - mx[h]);
        sum[h] += e;  // the denominator is fixed before dropout
        float p = e;
        if (a.drop.seed != nullptr)
          p = dropout_hash(sv, (uint32_t)((hg0 + h) * tile + r) * (uint32_t)wcols + j)
                      >= a.drop.thresh
                  ? e * a.drop.inv_keep : 0.f;
        *pp = mm_round<T>(p);
      }
    }
    warp_sums<HG>(sum);
    if (lane == 0)
#pragma unroll
      for (int h = 0; h < HG; ++h)
        if (hg0 + h < heads) invs[hg0 + h] = 1.f / fmaxf(sum[h], 1e-16f);
  }
  __syncwarp();

  // out: per column block and head group, U senders' z chunks of all the
  // group's heads in flight, summed in ascending sender order; the head
  // mean sums the heads in order
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
      R zb[U][HG][NG];
      for (int k0 = 0; k0 < cnt; k0 += U) {
        load_batch(hg0, cb, k0, zb);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 + u >= cnt) break;
#pragma unroll
          for (int h = 0; h < HG; ++h) {
            const float p = hg0 + h < heads ? pw[(hg0 + h) * wcols + k0 + u] : 0.f;
#pragma unroll
            for (int gi = 0; gi < NG; ++gi) {
              float zv[V];
              Ch::unpack(zb[u][h][gi], zv);
#pragma unroll
              for (int e = 0; e < V; ++e)
                acc[h][V * gi + e] = fmaf(p, zv[e], acc[h][V * gi + e]);
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < HG; ++h) {
        if (hg0 + h >= heads) continue;
        const float iv = invs[hg0 + h];
        if (CONCAT) {
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
        } else {
#pragma unroll
          for (int e = 0; e < MC; ++e) total[e] += acc[h][e] * iv;
        }
      }
    }
    if (!CONCAT) {
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
}

template <typename T, int V, bool EXACT, bool CONCAT>
int run(const GatArgs<T>& a, cudaStream_t stream) {
  const size_t per_warp = (size_t)4 * gat_words(a.wcols, a.heads);
  if (a.heads < 1 || a.wcols % 4 || a.wcols > 128 * MAX_WGROUPS
      || per_warp > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t fit = (size_t)SMEM_MAX / per_warp;
  const int warps = fit < (size_t)MAX_WARPS ? (int)fit : MAX_WARPS;
  const size_t smem = (size_t)warps * per_warp;
  auto kernel = gat_attention_kernel<T, V, EXACT, CONCAT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.n_pad + warps - 1) / warps, 32 * warps, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// 16-byte accesses, or 8-byte ones for a bf16 C that is not a multiple of
// 8; the fixed-count form when the heads fill one group and C one block
template <typename T, bool CONCAT>
int attention_v(const GatArgs<T>& a, cudaStream_t stream) {
  const bool exact = a.heads == HG && a.C <= CB;
  if constexpr (sizeof(T) == 2) {
    if (a.C % 8) return run<T, 4, false, CONCAT>(a, stream);
    return exact ? run<T, 8, true, CONCAT>(a, stream) : run<T, 8, false, CONCAT>(a, stream);
  } else {
    return exact ? run<T, 4, true, CONCAT>(a, stream) : run<T, 4, false, CONCAT>(a, stream);
  }
}

template <typename T>
int attention(const int8_t* mask, const float* alphas, const void* z,
              void* out, int n_pad, int heads, int c, int tile, int wcols,
              float slope, bool concat, Drop drop, cudaStream_t stream) {
  const GatArgs<T> a{mask, alphas, static_cast<const T*>(z), static_cast<T*>(out),
                     n_pad, heads, c, tile, wcols, slope, drop};
  return concat ? attention_v<T, true>(a, stream) : attention_v<T, false>(a, stream);
}

template <typename T>
int launch(const int8_t* mask, const void* w, const float* alphas,
           const void* x, void* z, void* out, int n_pad, int f, int heads,
           int c, int tile, int wcols, float slope, Drop drop,
           cudaStream_t stream) {
  // z = x·W (gemm_sm90.cuh, one weight, no bias); its operands move in
  // 16-byte chunks
  if (f % (16 / (int)sizeof(T)) || (heads * c) % (16 / (int)sizeof(T)))
    return (int)cudaErrorInvalidValue;
  const T* const ws[1] = {static_cast<const T*>(w)};
  cudaError_t err;
  if constexpr (sizeof(T) == 2)
    err = sm90::run_proj_fwd_bf16(static_cast<const T*>(x), ws, nullptr, 1,
                                  static_cast<T*>(z), n_pad, f, heads * c, stream);
  else
    err = sm90::f32::run_proj_fwd(static_cast<const T*>(x), ws, nullptr, 1,
                                  static_cast<T*>(z), n_pad, f, heads * c, stream);
  if (err != cudaSuccess) return (int)err;
  return attention<T>(mask, alphas, z, out, n_pad, heads, c, tile, wcols,
                      slope, false, drop, stream);
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
  const Drop drop{seed, thresh, inv_keep};
  if (dtype == 0)
    return launch<float>(mask, w, alphas, x, z, out, n_pad, f, heads, c, tile,
                         wcols, slope, drop, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mask, w, alphas, x, z, out, n_pad, f, heads,
                                 c, tile, wcols, slope, drop, s);
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
  const Drop drop{seed, thresh, inv_keep};
  if (dtype == 0)
    return attention<float>(mask, alphas, z, out, n_pad, heads, c, tile,
                            wcols, slope, concat != 0, drop, s);
  if (dtype == 1)
    return attention<__nv_bfloat16>(mask, alphas, z, out, n_pad, heads, c,
                                    tile, wcols, slope, concat != 0, drop, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
