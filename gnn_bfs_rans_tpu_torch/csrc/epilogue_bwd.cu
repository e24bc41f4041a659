// The BatchNorm epilogue's backward in one launch.
//
// Replaces the TPU kernel pair of gnn_bfs_rans_tpu/kernels/epilogue.py::
// _fused_vjp_bwd (_bwd_partials_kernel, _bwd_dx_kernel, and the XLA fold
// between them).  For xr [N, C] (the forward's residual x + x_new), the
// forward's per-channel vectors (m̃ the mean in xr's dtype, a = γ·inv_std,
// b̃ = β + (m̃ − mean)·a, inv_std), the batch mean and the cotangent g of
// y = dropout(relu((xr − m̃)·a + b̃)):
//
//   y_pre = round(round(round(xr − m̃)·a) + b̃)          (each op in xr's dtype)
//   g1    = [y_pre > 0] · keep · round(g·1/(1 − rate))   (keep: dropout.cuh)
//   x̂     = (xr − mean)·inv_std                          (f32)
//   G1    = Σ_rows g1,  G2 = Σ_rows g1·x̂                 (all N rows; f32)
//   dxr   = a·(g1 − (G1/n + x̂·G2/n)) on rows < n_valid, a·g1 on pad rows
//
// and dbias = G1, dscale = G2.  keep for element (row, c) is the hash of
// stream seed + row / B at (row mod B)·C + c, B the JAX package's row
// block (_pick_block), so masks are the JAX interpret-mode stream bit for
// bit.  Every rounding point is the plain version's
// (kernels/epilogue.py::fused_epilogue_bwd_plain): the arithmetic is
// written with __fsub_rn / __fmul_rn / __fadd_rn, which nvcc never
// contracts into a fused multiply-add (one ulp in bf16 flips hundreds of
// ReLU predicates).
//
// What bounds it on an H100: bytes.  g and xr read once and dxr written
// once, 3 × [12,032, 256] × 2 bytes = 18.5 MB in bf16, 5.5 µs at 3.35
// TB/s; a few dozen operations per element.  The JAX package's order (a
// partials pass, a fold, a dx pass) reads g and xr twice and puts a
// serial fold between two launches.  Here one cooperative launch of
// persistent blocks, as many as are co-resident, each owning a contiguous
// range of rows:
//
//   1. reads its rows of g and xr once (a thread's 4 columns fixed: 16-
//      or 8-byte accesses, 64 bytes of loads in flight; 8 columns a thread
//      in bf16 spilled registers), forms g1 and x̂, sums
//      its column partials (per thread in row order, then across the
//      block's row lanes in order) into part[block], and keeps g1 (exact
//      in xr's dtype) and xr in shared memory;
//   2. a grid-wide barrier; warp w folds column k = w, w + warps, … of
//      the partials in block order (lane-strided, then a butterfly: every
//      lane holds the same bits), writes dbias, dscale and (G1/n, G2/n);
//   3. a second barrier; every block forms dxr from its held tiles and
//      writes it once (and a bf16 copy where the other residual input is
//      bf16, the mixed form).
//
// When a block's rows do not fit in shared memory (N above ~25,000 rows at
// C 256 in bf16, ~13,800 in f32) phase 3 reads g and xr again from device
// memory and recomputes g1: a size branch of the same kernel.  The fold
// order is fixed by the grid, so a launch's results are deterministic (no
// float atomics).  The barrier's counter is the caller's one word for the
// launch's stream, zero at the start, and the launch leaves it at zero
// (coop.cuh::grid_done), so launches on different streams never share one
// and no memset precedes a launch.  The barrier, the block partition and
// the cooperative launch live in coop.cuh, shared with the forward
// (epilogue_fwd.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"
#include "dropout.cuh"

namespace {

using coop::from_f;
using coop::grid_done;
using coop::grid_sync;
using coop::rnd;
using coop::to_f;
using coop::Vec;

constexpr int THREADS = 512;
// rows whose loads a thread keeps in flight: 64 bytes of g and xr
template <typename T>
constexpr int UNROLL = 16 / sizeof(T);
constexpr int FOLD = 8;     // partials a lane loads at once in the fold

template <typename T>
struct Args {
  const T* g;        // [n, C] cotangent of y
  const T* xr;       // [n, C] the forward's residual
  const float* vec;  // [4, C]: m̃, a, b̃, inv_std
  const float* mean; // [C]
  const int* seed;   // null: no dropout
  uint32_t thresh;
  float scale;       // 1/(1 − rate) in T's precision
  int block;         // B: the dropout stream's row block
  int n, n_valid, C, rows;   // rows: a block's share
  float* part;       // [grid, 2, C]
  unsigned int* bar; // the grid barrier's counter: zero, and left so
  float* gvec;       // [2, C]: G1/n, G2/n
  float* dscale;     // [C]
  float* dbias;      // [C]
  T* dx;             // [n, C]
  __nv_bfloat16* dx_lo;   // [n, C] bf16 copy, or null
};

// per-thread constants of its V columns
template <int V>
struct Cols {
  float m[V], a[V], b[V];    // m̃, a, b̃ in T's precision
  float af[V], mu[V], is[V]; // a, mean, inv_std in f32
};

// g1 and x̂ of V columns of one row
template <typename T, int V>
__device__ __forceinline__ void g1_xhat(const Args<T>& p, const Cols<V>& k,
                                        const Vec<T, V>& gv, const Vec<T, V>& xv,
                                        int row, int c0, float (&g1)[V],
                                        float (&xh)[V]) {
  uint32_t seed = 0u, base = 0u;
  if (p.seed != nullptr) {
    seed = (uint32_t)*p.seed + (uint32_t)(row / p.block);
    base = (uint32_t)(row % p.block) * (uint32_t)p.C + (uint32_t)c0;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float x = to_f(xv.e[j]);
    float y = rnd<T>(__fsub_rn(x, k.m[j]));
    y = rnd<T>(__fmul_rn(y, k.a[j]));
    y = rnd<T>(__fadd_rn(y, k.b[j]));
    float g = to_f(gv.e[j]);
    if (p.seed != nullptr)
      g = dropout_hash(seed, base + j) >= p.thresh ? rnd<T>(__fmul_rn(g, p.scale)) : 0.f;
    g1[j] = y > 0.f ? g : 0.f;
    xh[j] = __fmul_rn(__fsub_rn(x, k.mu[j]), k.is[j]);
  }
}

template <typename T, int V, bool HELD>
__global__ void __launch_bounds__(THREADS, 1) epilogue_bwd_kernel(const Args<T> p) {
  extern __shared__ __align__(16) uint8_t smem[];
  using W = Vec<T, V>;
  const int C = p.C, cc = C / V, lanes = THREADS / cc;
  const int cq = threadIdx.x % cc, ty = threadIdx.x / cc, c0 = V * cq;
  const bool active = ty < lanes;
  float* red = reinterpret_cast<float*>(smem);   // [lanes, 2, C]
  W* held_g = reinterpret_cast<W*>(smem + (size_t)lanes * 2 * C * sizeof(float));
  W* held_x = held_g + (size_t)p.rows * cc;
  const int r0 = blockIdx.x * p.rows;
  const int r1 = min(p.n, r0 + p.rows);
  constexpr int U = UNROLL<T>;

  Cols<V> k;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = active ? c0 + j : 0;
    k.m[j] = rnd<T>(p.vec[c]);
    k.af[j] = p.vec[C + c];
    k.a[j] = rnd<T>(k.af[j]);
    k.b[j] = rnd<T>(p.vec[2 * C + c]);
    k.is[j] = p.vec[3 * C + c];
    k.mu[j] = p.mean[c];
  }

  // ---- phase 1: column partials of g1 and g1·x̂; the tiles held
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  if (active) {
    for (int rb = r0 + ty; rb < r1; rb += U * lanes) {
      W gv[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + u * lanes;
        if (r < r1) {
          gv[u] = *reinterpret_cast<const W*>(p.g + (size_t)r * C + c0);
          xv[u] = *reinterpret_cast<const W*>(p.xr + (size_t)r * C + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + u * lanes;
        if (r >= r1) break;
        float g1[V], xh[V];
        g1_xhat(p, k, gv[u], xv[u], r, c0, g1, xh);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] = __fadd_rn(s1[j], g1[j]);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(g1[j], xh[j]));
        }
        if (HELD) {
          W w;
#pragma unroll
          for (int j = 0; j < V; ++j) w.e[j] = from_f<T>(g1[j]);   // exact
          held_g[(size_t)(r - r0) * cc + cq] = w;
          held_x[(size_t)(r - r0) * cc + cq] = xv[u];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[(size_t)ty * 2 * C + c0 + j] = s1[j];
      red[(size_t)ty * 2 * C + C + c0 + j] = s2[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += THREADS) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s = __fadd_rn(s, red[(size_t)l * 2 * C + c]);
    p.part[(size_t)blockIdx.x * 2 * C + c] = s;
  }
  grid_sync(p.bar, 1u);

  // ---- phase 2: the fold, in block order, one column per warp
  const int warps = THREADS / 32, lane = threadIdx.x % 32;
  const float nf = (float)p.n_valid;
  for (int c = blockIdx.x * warps + threadIdx.x / 32; c < 2 * C;
       c += gridDim.x * warps) {
    float s = 0.f;
    for (int b0 = 0; b0 < (int)gridDim.x; b0 += 32 * FOLD) {
      float v[FOLD];   // loads in flight together, summed in block order
#pragma unroll
      for (int i = 0; i < FOLD; ++i) {
        const int b = b0 + 32 * i + lane;
        v[i] = b < (int)gridDim.x ? __ldcg(p.part + (size_t)b * 2 * C + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FOLD; ++i) s = __fadd_rn(s, v[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      if (c < C)
        p.dbias[c] = s;
      else
        p.dscale[c - C] = s;
      p.gvec[c] = __fdiv_rn(s, nf);
    }
  }
  grid_sync(p.bar, 2u);
  grid_done(p.bar, 2u);

  // ---- phase 3: dxr from the held tiles (or g and xr read again).  The
  // block reads G1/n and G2/n from L2 once, into the partials' shared
  // memory (every thread reading them there kept a few L2 slices busy)
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) red[i] = __ldcg(p.gvec + i);
  __syncthreads();
  if (!active) return;
  float g1n[V], g2n[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    g1n[j] = red[c0 + j];
    g2n[j] = red[C + c0 + j];
  }
  for (int rb = r0 + ty; rb < r1; rb += U * lanes) {
    W gv[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u * lanes;
      if (r < r1) {
        if (HELD) {
          gv[u] = held_g[(size_t)(r - r0) * cc + cq];
          xv[u] = held_x[(size_t)(r - r0) * cc + cq];
        } else {
          gv[u] = *reinterpret_cast<const W*>(p.g + (size_t)r * C + c0);
          xv[u] = *reinterpret_cast<const W*>(p.xr + (size_t)r * C + c0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u * lanes;
      if (r >= r1) break;
      float g1[V], xh[V];
      if (HELD) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          g1[j] = to_f(gv[u].e[j]);
          xh[j] = __fmul_rn(__fsub_rn(to_f(xv[u].e[j]), k.mu[j]), k.is[j]);
        }
      } else {
        g1_xhat(p, k, gv[u], xv[u], r, c0, g1, xh);
      }
      const bool real = r < p.n_valid;
      W out;
      Vec<__nv_bfloat16, V> lo;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = real ? __fsub_rn(g1[j], __fadd_rn(g1n[j], __fmul_rn(xh[j], g2n[j])))
                             : g1[j];
        const float v = __fmul_rn(k.af[j], d);
        out.e[j] = from_f<T>(v);
        lo.e[j] = __float2bfloat16_rn(v);
      }
      *reinterpret_cast<W*>(p.dx + (size_t)r * C + c0) = out;
      if (p.dx_lo != nullptr)
        *reinterpret_cast<Vec<__nv_bfloat16, V>*>(p.dx_lo + (size_t)r * C + c0) = lo;
    }
  }
}

template <typename T, int V, bool HELD>
cudaError_t launch(Args<T> p, int sms, int max_grid, cudaStream_t s) {
  const int cc = p.C / V, lanes = THREADS / cc;
  const size_t red = (size_t)lanes * 2 * p.C * sizeof(float);
  auto kernel = epilogue_bwd_kernel<T, V, HELD>;
  int grid = sms;
  if (!HELD) {
    int per_sm = 0;
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, red);
    if (e != cudaSuccess) return e;
    grid = per_sm * sms;
  }
  // no more blocks than row lanes' worth of rows, nor than part holds
  const coop::Partition part = coop::partition(p.n, lanes, grid, max_grid);
  if (part.grid < 1) return cudaErrorInvalidValue;
  p.rows = part.rows;
  const size_t smem = red + (HELD ? 2 * (size_t)p.rows * p.C * sizeof(T) : 0);
  return coop::launch(kernel, p, part.grid, THREADS, smem, s);
}

// the shared-memory branch when one block a SM can hold its rows
template <typename T, int V>
cudaError_t pick(const Args<T>& p, int sms, int max_grid, cudaStream_t s) {
  const int cc = p.C / V, lanes = THREADS / cc;
  const int grid = sms < max_grid ? sms : max_grid;
  const size_t rows = (p.n + grid - 1) / grid;
  const size_t held = (size_t)lanes * 2 * p.C * sizeof(float)
                      + 2 * rows * p.C * sizeof(T);
  if (held <= (size_t)coop::SMEM_MAX) return launch<T, V, true>(p, sms, max_grid, s);
  return launch<T, V, false>(p, sms, max_grid, s);
}

template <typename T>
int run(Args<T> p, int max_grid, cudaStream_t s) {
  if (p.C < 1 || p.n < 1 || p.n_valid < 1 || p.n_valid > p.n || p.block < 1
      || max_grid < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool aligned = ((uintptr_t)p.g | (uintptr_t)p.xr | (uintptr_t)p.dx
                        | (uintptr_t)p.dx_lo) % (4 * sizeof(T)) == 0;
  if (p.C % 4 == 0 && aligned && p.C / 4 <= THREADS)
    return (int)pick<T, 4>(p, sms, max_grid, s);
  if (p.C <= THREADS) return (int)pick<T, 1>(p, sms, max_grid, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Row 3.  dtype (of g, xr and dx): 0 = float32, 1 = bfloat16.  vec f32 [4,
// C] (m̃, a, b̃, inv_std), mean f32 [C]; seed: device pointer to one int32,
// or null for no dropout (thresh, scale = 1/(1 − rate) in dtype's
// precision, block: the stream's row block).  part f32 [max_grid, 2, C]
// and gvec f32 [2, C] are scratch; bar is the stream's barrier counter
// (one word, zero, left at zero); dscale, dbias f32 [C]; dx [n, C] in dtype,
// dx_lo null or a bf16 [n, C] copy (f32 dtype only).  C ≤ 512, or C a
// multiple of 4 up to 2,048 with g, xr, dx and dx_lo aligned to 4
// elements.  Returns the CUDA error code of the launch (0 on success).
int epilogue_bwd_launch(const void* g, const void* xr, const float* vec,
                        const float* mean, const int* seed, unsigned int thresh,
                        float scale, int block, int n, int n_valid, int c,
                        float* part, unsigned int* bar, int max_grid,
                        float* gvec, float* dscale,
                        float* dbias, void* dx, void* dx_lo, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>({static_cast<const float*>(g), static_cast<const float*>(xr),
                       vec, mean, seed, thresh, scale, block, n, n_valid, c, 0,
                       part, bar, gvec, dscale, dbias, static_cast<float*>(dx),
                       static_cast<__nv_bfloat16*>(dx_lo)},
                      max_grid, s);
  if (dtype == 1 && dx_lo == nullptr)
    return run<__nv_bfloat16>({static_cast<const __nv_bfloat16*>(g),
                               static_cast<const __nv_bfloat16*>(xr), vec, mean,
                               seed, thresh, scale, block, n, n_valid, c, 0,
                               part, bar, gvec, dscale, dbias,
                               static_cast<__nv_bfloat16*>(dx), nullptr},
                              max_grid, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
