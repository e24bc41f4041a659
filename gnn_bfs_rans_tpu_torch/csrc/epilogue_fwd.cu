// The BatchNorm epilogue's forward in one launch.
//
// Replaces the TPU kernel pair of gnn_bfs_rans_tpu/kernels/epilogue.py::
// _fused_fwd_impl (_res_stats_kernel, _fwd_kernel, and the XLA _make_vec
// between them).  For x, x_new [N, C] (x_new may be bf16 under an f32 x:
// the mixed form; xr takes the wider dtype T), the BatchNorm scale γ and
// bias β [C]:
//
//   xr    = round_T(x + x_new)
//   Σxr, Σxr²  over rows < n_valid (f32)
//   mean  = Σxr/n,  var = max(Σxr²/n − mean², 0),  inv_std = rsqrt(var + ε)
//   a     = γ·inv_std,  m̃ = round_T(mean),  b̃ = β + (m̃ − mean)·a
//   y     = dropout(relu(round(round(round(xr − m̃)·a) + b̃)))   (each op in T)
//
// on every row, and writes y, xr (the backward's residual), mean, var and
// vec = [m̃, a, b̃, inv_std] ([4, C] f32).  dropout keeps element (row, c)
// when the hash of stream seed + row / B at (row mod B)·C + c is at least
// thresh (dropout.cuh; B the JAX package's row block, _pick_block), and
// scales it by 1/(1 − rate) rounded to T: the JAX interpret-mode stream
// bit for bit.  Every rounding point is the plain version's
// (kernels/epilogue.py::_forward_plain): the arithmetic is written with
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, which nvcc never
// contracts into a fused multiply-add (one ulp in bf16 flips ReLU
// predicates the backward recomputes), and rsqrt is __frsqrt_rn.
//
// What bounds it on an H100: bytes.  x and x_new read once, xr and y
// written once: 4 × [12,032, 256] × 2 bytes = 24.6 MB in bf16, 7.4 µs at
// 3.35 TB/s; a dozen operations per element, and the dropout hash's
// dozen more; in bf16 four f32 → bf16 roundings an element, which convert
// two values at a time (round_pack).  The JAX package's order (a residual-and-partials pass, a
// fold, an affine pass) reads xr back and puts a serial fold between two
// launches.  Here one cooperative launch of persistent blocks, as many as
// are co-resident, each owning a contiguous range of rows (coop.cuh):
//
//   1. reads its rows of x and x_new once (a thread's 4 columns fixed:
//      16- or 8-byte accesses, 128 bytes of loads in flight), forms xr,
//      writes it once and keeps it in shared memory, and sums its column
//      partials (per thread in row order, then across the block's row
//      lanes in order) into part[block];
//   2. a grid-wide barrier; one warp a column pair (Σxr, Σxr²), spread over
//      the blocks (column w·grid + b in warp w of block b), folds it in
//      block order, lane-strided then by a butterfly, with γ and β loaded
//      at the kernel's start, and writes the column's statistics;
//   3. the block arrives at a second barrier and, until every block has,
//      draws the keep bits of its rows (a byte a row and thread, beside
//      the tile; half of them already while the first barrier fills): the
//      dropout hash runs while the block would wait;
//   4. every block reads the statistics from L2 once into shared memory
//      (all threads reading them there kept the few L2 slices that hold
//      them busy: about 2 µs a launch on an H100), forms y from its held
//      tile and writes it once.
//
// The fold is deterministic (no float atomics) and every block reads the
// same statistics.  (Folding every column in every block instead saves
// the second barrier, but reads grid × 2C × 4 bytes of L2 a block, 270 KB
// at the flagship's 131 blocks, and leaves no window for the hash.)  When
// a block's rows do not fit in shared memory (N above ~49,000 rows at C
// 256 in bf16, ~26,000 in f32) phase 4 reads its own xr back from device
// memory and draws the bits there: a size branch of the same kernel.
// The barrier's counter is the caller's word for the stream, zero, and
// left at zero (coop.cuh::grid_done): no memset precedes a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"
#include "dropout.cuh"

namespace {

using coop::from_f;
using coop::grid_arrive;
using coop::grid_done;
using coop::grid_sync;
using coop::grid_wait;
using coop::rnd;
using coop::to_f;
using coop::Vec;

constexpr int THREADS = 512;
// rows whose loads a thread keeps in flight: 64 bytes of x (and of x_new)
template <typename T>
constexpr int UNROLL = 16 / sizeof(T);
constexpr int FOLD = 8;     // partials a lane loads at once in the fold

template <typename T, typename TN>
struct Args {
  const T* x;          // [n, C]
  const TN* xn;        // [n, C] x_new (bf16 under an f32 T: the mixed form)
  const float* scale;  // [C] γ
  const float* bias;   // [C] β
  const int* seed;     // null: no dropout
  uint32_t thresh;
  float dscale;        // 1/(1 − rate) in T's precision
  int block;           // B: the dropout stream's row block
  int n, n_valid, C, rows;   // rows: a block's share
  float eps;
  float* part;         // [grid, 2, C]
  unsigned int* bar;   // the grid barrier's counter: zero, and left so
  float* vec;          // [4, C]: m̃, a, b̃, inv_std
  float* mean;         // [C]
  float* var;          // [C]
  T* xr;               // [n, C]
  T* y;                // [n, C]
};

// The statistics of one column from its sums and its γ, β: mean, var and
// the column of vec.
template <typename T, typename TN>
__device__ __forceinline__ void finalize(const Args<T, TN>& p, int c, float s1,
                                         float s2, float gamma, float beta) {
  const float nf = (float)p.n_valid;
  const float mean = __fdiv_rn(s1, nf);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, nf), __fmul_rn(mean, mean)), 0.f);
  const float inv = __frsqrt_rn(__fadd_rn(var, p.eps));
  const float a = __fmul_rn(gamma, inv);
  const float m_lo = rnd<T>(mean);
  p.mean[c] = mean;
  p.var[c] = var;
  p.vec[c] = m_lo;
  p.vec[p.C + c] = a;
  p.vec[2 * p.C + c] = __fadd_rn(beta, __fmul_rn(__fsub_rn(m_lo, mean), a));
  p.vec[3 * p.C + c] = inv;
}

// v rounded to T's precision, and its bits as T.  bf16 rounds two values
// a conversion (cvt.rn.bf16x2.f32): an SM converts at a fraction of its
// f32 rate, and the affine pass rounds four times an element.
template <typename T, int V>
__device__ __forceinline__ void round_pack(float (&v)[V], Vec<T, V>& out) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < V; ++j) out.e[j] = from_f<T>(v[j]);
  } else if constexpr (V % 2 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[j], v[j + 1]);
      const float2 f = __bfloat1622float2(h);
      v[j] = f.x;
      v[j + 1] = f.y;
      out.e[j] = h.x;
      out.e[j + 1] = h.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out.e[j] = from_f<T>(v[j]);
      v[j] = to_f(out.e[j]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void round_v(float (&v)[V]) {
  Vec<T, V> unused;
  round_pack<T, V>(v, unused);
}

// The keep bits of V columns of one row (bit j: column c0 + j).
template <int V>
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed, uint32_t thresh,
                                              int block, int C, int r, int c0) {
  const uint32_t sr = seed + (uint32_t)(r / block);
  const uint32_t base = (uint32_t)(r % block) * (uint32_t)C + (uint32_t)c0;
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < V; ++j)
    bits |= (dropout_hash(sr, base + j) >= thresh ? 1u : 0u) << j;
  return bits;
}

// rows of C floats at the front of shared memory: the row lanes' partials,
// then m̃, a and b̃
__host__ __device__ constexpr int red_rows(int lanes) {
  return 2 * lanes > 3 ? 2 * lanes : 3;
}

template <typename T, typename TN, int V, bool HELD>
__global__ void __launch_bounds__(THREADS, 1) epilogue_fwd_kernel(const Args<T, TN> p) {
  extern __shared__ __align__(16) uint8_t smem[];
  using W = Vec<T, V>;
  using WN = Vec<TN, V>;
  const int C = p.C, cc = C / V, lanes = THREADS / cc;
  const int cq = threadIdx.x % cc, ty = threadIdx.x / cc, c0 = V * cq;
  const bool active = ty < lanes;
  float* red = reinterpret_cast<float*>(smem);      // [lanes, 2, C], later m̃, a, b̃
  W* held = reinterpret_cast<W*>(red + (size_t)red_rows(lanes) * C);
  // the keep bits of each held (row, thread), drawn in the barriers' windows
  uint8_t* kept = reinterpret_cast<uint8_t*>(held + (HELD ? (size_t)p.rows * cc : 0));
  const int r0 = blockIdx.x * p.rows;
  const int r1 = min(p.n, r0 + p.rows);
  constexpr int U = UNROLL<T>;
  const bool drop = p.seed != nullptr;
  const uint32_t seed = drop ? (uint32_t)*p.seed : 0u;
  // the column this warp folds (block c mod grid, warp c / grid), its γ
  // and β loaded before they are needed
  const int warps = THREADS / 32, lane = threadIdx.x % 32;
  const int fc = (threadIdx.x / 32) * (int)gridDim.x + blockIdx.x;
  const float fgamma = fc < C ? p.scale[fc] : 0.f;
  const float fbeta = fc < C ? p.bias[fc] : 0.f;

  // ---- phase 1: xr written and held; its column partials
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  if (active) {
    for (int rb = r0 + ty; rb < r1; rb += U * lanes) {
      W xv[U];
      WN nv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + u * lanes;
        if (r < r1) {
          xv[u] = *reinterpret_cast<const W*>(p.x + (size_t)r * C + c0);
          nv[u] = *reinterpret_cast<const WN*>(p.xn + (size_t)r * C + c0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = rb + u * lanes;
        if (r >= r1) break;
        const bool real = r < p.n_valid;
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fadd_rn(to_f(xv[u].e[j]), to_f(nv[u].e[j]));
        W w;
        round_pack<T, V>(v, w);
        if (real) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            s1[j] = __fadd_rn(s1[j], v[j]);
            s2[j] = __fadd_rn(s2[j], __fmul_rn(v[j], v[j]));
          }
        }
        *reinterpret_cast<W*>(p.xr + (size_t)r * C + c0) = w;
        if (HELD) held[(size_t)(r - r0) * cc + cq] = w;
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
  // the keep bits of the thread's first rows while the grid arrives
  const bool draw = HELD && drop && active;
  const int half = active ? ((r1 - r0 - ty + lanes - 1) / lanes + 1) / 2 : 0;
  grid_arrive(p.bar);
  if (draw)
    for (int k = 0; k < half; ++k) {
      const int r = r0 + ty + k * lanes;
      kept[(size_t)(r - r0) * cc + cq] =
          (uint8_t)keep_bits<V>(seed, p.thresh, p.block, C, r, c0);
    }
  grid_wait(p.bar, 1u);

  // ---- phase 2: the fold, in block order: warp w of block b folds the
  // column pair of column w·grid + b, block b' in lane b' mod 32
  const int grid = (int)gridDim.x;
  for (int c = fc; c < C; c += grid * warps) {
    float a1 = 0.f, a2 = 0.f;
    for (int b0 = 0; b0 < grid; b0 += 32 * FOLD) {
      float v1[FOLD], v2[FOLD];   // loads in flight together
#pragma unroll
      for (int i = 0; i < FOLD; ++i) {
        const int b = b0 + 32 * i + lane;
        v1[i] = b < grid ? __ldcg(p.part + (size_t)b * 2 * C + c) : 0.f;
        v2[i] = b < grid ? __ldcg(p.part + (size_t)b * 2 * C + C + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FOLD; ++i) {
        a1 = __fadd_rn(a1, v1[i]);
        a2 = __fadd_rn(a2, v2[i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a1 = __fadd_rn(a1, __shfl_xor_sync(0xffffffffu, a1, o));
      a2 = __fadd_rn(a2, __shfl_xor_sync(0xffffffffu, a2, o));
    }
    if (lane == 0)
      finalize(p, c, a1, a2, c == fc ? fgamma : p.scale[c],
               c == fc ? fbeta : p.bias[c]);
  }

  // ---- phase 3: the rest of the keep bits, while the other blocks fold
  grid_arrive(p.bar);
  if (draw)
    for (int r = r0 + ty + half * lanes; r < r1; r += lanes)
      kept[(size_t)(r - r0) * cc + cq] =
          (uint8_t)keep_bits<V>(seed, p.thresh, p.block, C, r, c0);
  grid_wait(p.bar, 2u);
  grid_done(p.bar, 2u);

  // ---- phase 4: y from the held tile (or xr read back).  The block reads
  // m̃, a and b̃ from L2 once, into the partials' shared memory: every
  // thread reading them there kept the few L2 slices holding them busy
  for (int i = threadIdx.x; i < 3 * C; i += THREADS) red[i] = __ldcg(p.vec + i);
  __syncthreads();
  if (!active) return;
  float m[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j;
    m[j] = rnd<T>(red[c]);
    a[j] = rnd<T>(red[C + c]);
    b[j] = rnd<T>(red[2 * C + c]);
  }
  W zero;   // +0 in T
#pragma unroll
  for (int j = 0; j < V; ++j) zero.e[j] = from_f<T>(0.f);
  for (int rb = r0 + ty; rb < r1; rb += U * lanes) {
    W xv[U];
    uint32_t kb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u * lanes;
      if (r < r1) {   // the xr this thread wrote in phase 1
        xv[u] = HELD ? held[(size_t)(r - r0) * cc + cq]
                     : *reinterpret_cast<const W*>(p.xr + (size_t)r * C + c0);
        kb[u] = !drop ? 0u
                : HELD ? kept[(size_t)(r - r0) * cc + cq]
                       : keep_bits<V>(seed, p.thresh, p.block, C, r, c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rb + u * lanes;
      if (r >= r1) break;
      float y[V];
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = __fsub_rn(to_f(xv[u].e[j]), m[j]);
      round_v<T, V>(y);
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = __fmul_rn(y[j], a[j]);
      round_v<T, V>(y);
#pragma unroll
      for (int j = 0; j < V; ++j) y[j] = __fadd_rn(y[j], b[j]);
      W out;
      round_pack<T, V>(y, out);   // the affine, rounded: its bits are y's
#pragma unroll
      for (int j = 0; j < V; ++j)   // relu
        if (!(y[j] > 0.f)) {
          y[j] = 0.f;
          out.e[j] = zero.e[j];
        }
      if (drop) {   // a kept value scaled by 1/(1 − rate), rounded once more
#pragma unroll
        for (int j = 0; j < V; ++j)
          y[j] = (kb[u] >> j) & 1u ? __fmul_rn(y[j], p.dscale) : 0.f;
        round_pack<T, V>(y, out);
      }
      *reinterpret_cast<W*>(p.y + (size_t)r * C + c0) = out;
    }
  }
}

// a block's held xr tile and its keep bits (a byte a row and thread)
template <typename T>
size_t held_bytes(int rows, int C, int cc) {
  return (size_t)rows * C * sizeof(T) + (size_t)rows * cc;
}

template <typename T, typename TN, int V, bool HELD>
cudaError_t launch(Args<T, TN> p, int sms, int max_grid, cudaStream_t s) {
  const int cc = p.C / V, lanes = THREADS / cc;
  const size_t red = (size_t)red_rows(lanes) * p.C * sizeof(float);
  auto kernel = epilogue_fwd_kernel<T, TN, V, HELD>;
  int grid = sms;
  if (!HELD) {
    int per_sm = 0;
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, red);
    if (e != cudaSuccess) return e;
    grid = per_sm * sms;
  }
  const coop::Partition part = coop::partition(p.n, lanes, grid, max_grid);
  if (part.grid < 1) return cudaErrorInvalidValue;
  p.rows = part.rows;
  const size_t smem = red + (HELD ? held_bytes<T>(p.rows, p.C, cc) : 0);
  return coop::launch(kernel, p, part.grid, THREADS, smem, s);
}

// the shared-memory branch when one block a SM can hold its rows
template <typename T, typename TN, int V>
cudaError_t pick(const Args<T, TN>& p, int sms, int max_grid, cudaStream_t s) {
  const int cc = p.C / V, lanes = THREADS / cc;
  const coop::Partition part = coop::partition(p.n, lanes, sms, max_grid);
  const size_t held = (size_t)red_rows(lanes) * p.C * sizeof(float)
                      + held_bytes<T>(part.rows, p.C, cc);
  if (held <= (size_t)coop::SMEM_MAX) return launch<T, TN, V, true>(p, sms, max_grid, s);
  return launch<T, TN, V, false>(p, sms, max_grid, s);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

template <typename T, typename TN>
int run(const Args<T, TN>& p, int max_grid, cudaStream_t s) {
  if (p.C < 1 || p.n < 1 || p.n_valid < 1 || p.n_valid > p.n || p.block < 1
      || max_grid < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const bool aligned =
      ((uintptr_t)p.x | (uintptr_t)p.xr | (uintptr_t)p.y) % (4 * sizeof(T)) == 0
      && (uintptr_t)p.xn % (4 * sizeof(TN)) == 0;
  if (p.C % 4 == 0 && aligned && p.C / 4 <= THREADS)
    return (int)pick<T, TN, 4>(p, sms, max_grid, s);
  if (p.C <= THREADS) return (int)pick<T, TN, 1>(p, sms, max_grid, s);
  return (int)cudaErrorInvalidValue;
}

__global__ void __launch_bounds__(THREADS, 1) barrier_probe_kernel(unsigned int* bar) {
  grid_sync(bar, 1u);
  grid_done(bar, 1u);
}

}  // namespace

extern "C" {

// Row 2.  dtype (of x, xr and y) and xn_dtype (of x_new): 0 = float32, 1 =
// bfloat16; (0, 0), (0, 1) (the mixed form) or (1, 1).  scale, bias f32
// [C]; seed: device pointer to one int32, or null for no dropout (thresh,
// dscale = 1/(1 − rate) in dtype's precision, block: the stream's row
// block).  part f32 [max_grid, 2, C] is scratch; bar is the stream's
// barrier counter (one word, zero, left at zero); vec f32 [4, C], mean and
// var f32 [C]; xr and y [n, C] in dtype.  C ≤ 512, or C a multiple of 4
// up to 2,048 with x, x_new, xr and y aligned to 4 elements.  Returns the CUDA error
// code of the launch (0 on success).
int epilogue_fwd_launch(const void* x, const void* xn, const float* scale,
                        const float* bias, const int* seed, unsigned int thresh,
                        float dscale, int block, int n, int n_valid, int c,
                        float eps, float* part, unsigned int* bar, int max_grid,
                        float* vec, float* mean, float* var, void* xr, void* y,
                        int dtype, int xn_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && xn_dtype == 0)
    return run<float, float>(
        {static_cast<const float*>(x), static_cast<const float*>(xn), scale, bias,
         seed, thresh, dscale, block, n, n_valid, c, 0, eps, part, bar, vec, mean,
         var, static_cast<float*>(xr), static_cast<float*>(y)},
        max_grid, s);
  if (dtype == 0 && xn_dtype == 1)
    return run<float, bf16>(
        {static_cast<const float*>(x), static_cast<const bf16*>(xn), scale, bias,
         seed, thresh, dscale, block, n, n_valid, c, 0, eps, part, bar, vec, mean,
         var, static_cast<float*>(xr), static_cast<float*>(y)},
        max_grid, s);
  if (dtype == 1 && xn_dtype == 1)
    return run<bf16, bf16>(
        {static_cast<const bf16*>(x), static_cast<const bf16*>(xn), scale, bias,
         seed, thresh, dscale, block, n, n_valid, c, 0, eps, part, bar, vec, mean,
         var, static_cast<bf16*>(xr), static_cast<bf16*>(y)},
        max_grid, s);
  return (int)cudaErrorInvalidValue;
}

// The launch's fixed cost, for kernels/rowtime.py: a cooperative launch of
// as many blocks as row 2 takes at n rows of C columns, each of which only
// meets the others at one grid barrier.
int grid_barrier_probe_launch(unsigned int* bar, int n, int c, void* stream) {
  const int cc = c % 4 == 0 ? c / 4 : c;   // threads a row, as row 2 takes
  if (n < 1 || c < 1 || cc > THREADS) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(&sms);
  if (e != 0) return e;
  const int lanes = THREADS / cc;
  const coop::Partition part = coop::partition(n, lanes, sms, sms);
  return (int)coop::launch(barrier_probe_kernel, bar, part.grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
