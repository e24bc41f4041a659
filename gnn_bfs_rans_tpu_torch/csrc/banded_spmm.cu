// Banded SpMM: the GCN and GIN neighbour aggregation over the block band.
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded.py::banded_spmm_fwd
// (_spmm_kernel).  Computes, for every receiver row r = t·T + i,
//
//   out[r] = Σ_{k < W} Σ_{j < T} A[t, k, i, j] · x[(t − k0 + k)·T + j],  k0 = W/2
//
// with A the [n_tiles, W, T, T] band plane (the f32 GCN coefficients or the
// bf16 0/1 adjacency) and x [n_pad, F] in f32 or bf16.  Every product is an
// exact f32 product (bf16 values widen exactly), the sum is f32, and the
// result rounds once to x's dtype.  So GCN's f32 coefficients are never
// rounded, in bf16 as in f32: the JAX package's interpret path promotes the
// bf16 features to f32 in the same way.  Window blocks whose sender tile
// lies outside [0, n_tiles) are skipped and never read (build_band leaves
// them zero; the TPU kernel clamps its window onto a duplicate tile and
// relies on those zeros, which a CUDA kernel must not copy: it would read
// outside x).  The backward is this kernel on the transposed band
// (kernels/banded.py::transpose_band).
//
// What bounds it on an H100: the TPU kernel runs W dense T×T products per
// tile on its matrix unit, 2·n_tiles·W·T²·F operations — 2.37 GFLOP at N
// 12,032, F 256, W 3, about 35 µs on the SIMT units in f32 (f32 coefficients
// rule out TF32 and bf16 tensor cores).  The band holds about 5 nonzeros per
// row (59k at that mesh: 47,140 edges plus 12,000 self-loops), 2·nnz·F = 30
// MFLOP, so the work the data needs is bound by bytes: the plane (18.5 MB in
// f32, 9.2 MB in bf16), x and out.  Only the nonzero entries' x rows are
// read, and zero coefficients are never multiplied.
//
// Design: persistent warps, one receiver row at a time, with their loads
// in flight together (the first design walked a row's W·T coefficients in
// rounds of 32, a load, a ballot and, for each nonzero, a dependent x-row
// load: a dozen latencies a row).  For each of its rows a warp
//   1. has its row's coefficients in registers, CHUNKS (k, group) chunks a
//      round (all of them at W 3, T 128): lane l holds the 4 of window
//      block k at columns 4l … 4l + 3 (+ 128 per 128-column group), one
//      16-byte load (8 in bf16) a chunk, all issued together;
//   2. compacts the nonzeros of each chunk into a list in shared memory,
//      (coefficient, sender row) in ascending window column: four ballots
//      (one per column of a lane's 4) and their population counts below
//      the lane place each entry, no serial scan;
//   3. issues the loads of its next row's first round, which arrive while
//      it
//   4. walks the list in batches of BATCH senders: the coefficients read
//      back (one broadcast each), every x-row load of the batch issued
//      before any multiply-add (a lane's 8 columns of a 256-column chunk,
//      16 bytes a load: 8 adjacent bf16 columns, or two groups of 4 f32),
//      then one fmaf per product in list order.  A batch past the end of
//      the list loads and adds nothing.
// Rows wider than CHUNKS chunks (W 5) load, compact and walk their later
// rounds in order.  The list holds a round (3 × 128 entries, 3 KB a
// warp).  So a row's critical path is its compaction and walk, and the
// coefficients' latency (they come from device memory) is hidden behind
// the previous row's walk.
// Every output element is one chain of fmaf in ascending window column
// from 0.f, rounded once to x's dtype: the same order as the first
// design, so the outputs are bit-identical to it.  blockIdx.y picks the
// 256-column chunk.  F must be a multiple of 4 (8 for the bf16 16-byte
// form) and T a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band_common.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;   // warps a block
constexpr int MIN_BLOCKS = 3;       // blocks an SM holds: ≤ 80 registers a thread
constexpr int COL_CHUNK = 256;      // columns a warp covers, 8 a lane
constexpr int CHUNKS = 3;           // (k, group) coefficient chunks a round loads
constexpr int CAP = 128 * CHUNKS;   // list entries a warp holds: one round's

using band::Chunk;

struct Entry {
  float coef;
  int row;   // the sender's row of x
};

// senders a batch keeps in flight: 64 bytes of x loads a lane
template <typename TX>
constexpr int BATCH = 64 / (8 * sizeof(TX));

// A lane's 4 coefficients of one chunk, as loaded
template <typename TA> struct Coef;
template <> struct Coef<float> {
  using raw = float4;
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(const raw& r, float (&v)[4]) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
};
template <> struct Coef<__nv_bfloat16> {
  using raw = uint2;
  static __device__ __forceinline__ raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void unpack(const raw& r, float (&v)[4]) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

// The band's geometry and a warp's place in it
struct Geo {
  int n_tiles, tile, window, groups, n_chunks, lane;
};

// Round q0's coefficients of `row` (zero for a chunk past the row's,
// outside the window's tiles or past the tile), every load issued at once
template <typename TA>
__device__ __forceinline__ void load_round(const TA* __restrict__ a, const Geo& g,
                                           int row, int q0,
                                           typename Coef<TA>::raw (&v)[CHUNKS]) {
  using R = typename Coef<TA>::raw;
  const int t = row / g.tile, i = row % g.tile;
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int k = (q0 + q) / g.groups, j = 128 * ((q0 + q) % g.groups) + 4 * g.lane;
    const int st = t - g.window / 2 + k;
    v[q] = q0 + q < g.n_chunks && st >= 0 && st < g.n_tiles && j < g.tile
               ? *reinterpret_cast<const R*>(
                     a + (((size_t)t * g.window + k) * g.tile + i) * g.tile + j)
               : Coef<TA>::zero();
  }
}

// The nonzeros of round q0 into the list, in ascending window column;
// returns their count
template <typename TA>
__device__ __forceinline__ int compact(const typename Coef<TA>::raw (&v)[CHUNKS],
                                       const Geo& g, int row, int q0, Entry* list) {
  const unsigned below = (1u << g.lane) - 1u;
  const int t = row / g.tile;
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    if (q0 + q >= g.n_chunks) break;   // warp-uniform
    float c4[4];
    Coef<TA>::unpack(v[q], c4);
    int before = 0, total = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned bal = __ballot_sync(0xffffffffu, c4[b] != 0.f);
      before += __popc(bal & below);
      total += __popc(bal);
    }
    const int k = (q0 + q) / g.groups, j = 128 * ((q0 + q) % g.groups) + 4 * g.lane;
    const int sender = (t - g.window / 2 + k) * g.tile + j;
    int pos = cnt + before;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c4[b] != 0.f) list[pos++] = Entry{c4[b], sender + b};
    cnt += total;
  }
  return cnt;
}

// The list's entries [0, cnt) into acc, in order: batches of B senders,
// every x-row load of a batch issued before its multiply-adds.
template <typename TX, int V>
__device__ __forceinline__ void walk(const Entry* list, int cnt,
                                     const TX* __restrict__ x, int f,
                                     int c_base, int lane, float (&acc)[8]) {
  constexpr int NG = 8 / V;
  constexpr int B = BATCH<TX>;
  using R = typename Chunk<TX, V>::raw;
  __syncwarp();
  for (int e0 = 0; e0 < cnt; e0 += B) {
    Entry en[B];
    R xv[B][NG];
#pragma unroll
    for (int u = 0; u < B; ++u)
      if (e0 + u < cnt) en[u] = list[e0 + u];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (e0 + u >= cnt) break;   // warp-uniform
      const TX* xr = x + (size_t)en[u].row * f;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = c_base + V * lane + 32 * V * g;
        if (c < f) xv[u][g] = *reinterpret_cast<const R*>(xr + c);
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      if (e0 + u >= cnt) break;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c = c_base + V * lane + 32 * V * g;
        if (c < f) {
          float v[V];
          Chunk<TX, V>::unpack(xv[u][g], v);
#pragma unroll
          for (int q = 0; q < V; ++q)
            acc[V * g + q] = fmaf(en[u].coef, v[q], acc[V * g + q]);
        }
      }
    }
  }
  __syncwarp();   // every read done before the list is written again
}

template <typename TA, typename TX, int V>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK, MIN_BLOCKS) spmm_kernel(
    const TA* __restrict__ a,   // [n_tiles, W, T, T]
    const TX* __restrict__ x,   // [n_pad, F]
    TX* __restrict__ out,       // [n_pad, F]
    int n_pad, int f, int tile, int window) {
  constexpr int NG = 8 / V;     // V-column groups a lane covers
  using R = typename Chunk<TX, V>::raw;
  __shared__ Entry lists[ROWS_PER_BLOCK][CAP];
  const int warp = threadIdx.x / 32;
  const int groups = (tile + 127) / 128;
  const Geo g{n_pad / tile, tile, window, groups, window * groups,
              (int)threadIdx.x % 32};
  const int stride = gridDim.x * ROWS_PER_BLOCK;
  const int c_base = blockIdx.y * COL_CHUNK;
  Entry* list = lists[warp];
  int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= n_pad) return;  // whole warp: no block-wide barrier below
  typename Coef<TA>::raw v[CHUNKS];
  load_round(a, g, row, 0, v);

  for (; row < n_pad; row += stride) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    for (int q0 = 0; q0 < g.n_chunks; q0 += CHUNKS) {
      if (q0 > 0) load_round(a, g, row, q0, v);
      const int cnt = compact<TA>(v, g, row, q0, list);
      // the next row's first round arrives during this walk
      if (q0 + CHUNKS >= g.n_chunks && row + stride < n_pad)
        load_round(a, g, row + stride, 0, v);
      walk<TX, V>(list, cnt, x, f, c_base, g.lane, acc);
    }
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const int c = c_base + V * g.lane + 32 * V * gi;
      if (c < f)
        *reinterpret_cast<R*>(out + (size_t)row * f + c) = Chunk<TX, V>::pack(&acc[V * gi]);
    }
  }
}

template <typename TA, typename TX, int V>
int launch(const void* a, const void* x, void* out, int n_pad, int f,
           int tile, int window, cudaStream_t stream) {
  auto kernel = spmm_kernel<TA, TX, V>;
  // persistent blocks: as many as the SMs hold at once, at most one a row
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * ROWS_PER_BLOCK, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int by_rows = (n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  dim3 grid(by_rows < resident ? by_rows : resident, (f + COL_CHUNK - 1) / COL_CHUNK);
  kernel<<<grid, 32 * ROWS_PER_BLOCK, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TX*>(x),
      static_cast<TX*>(out), n_pad, f, tile, window);
  return (int)cudaGetLastError();
}

// bf16 x in 16-byte accesses (8 columns) where F and the pointers allow
template <typename TA>
int launch_bf16(const void* a, const void* x, void* out, int n_pad, int f,
                int tile, int window, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (f % 8 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0)
    return launch<TA, bf16, 8>(a, x, out, n_pad, f, tile, window, s);
  return launch<TA, bf16, 4>(a, x, out, n_pad, f, tile, window, s);
}

}  // namespace

extern "C" {

// a_dtype, x_dtype: 0 = float32, 1 = bfloat16 (out shares x's).  a is the
// [n_pad/tile, window, tile, tile] band plane (tile a multiple of 4, the
// plane aligned to 16 bytes), x and out [n_pad, f] (f a multiple of 4, 16-
// byte aligned).  Returns the CUDA error code of the launch (0 on
// success).
int banded_spmm_launch(const void* a, const void* x, void* out, int n_pad,
                       int f, int tile, int window, int a_dtype, int x_dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (f % 4 != 0 || tile % 4 != 0 || tile < 1 || window < 1)
    return (int)cudaErrorInvalidValue;
  if (a_dtype == 0 && x_dtype == 0)
    return launch<float, float, 4>(a, x, out, n_pad, f, tile, window, s);
  if (a_dtype == 0 && x_dtype == 1)
    return launch_bf16<float>(a, x, out, n_pad, f, tile, window, s);
  if (a_dtype == 1 && x_dtype == 0)
    return launch<bf16, float, 4>(a, x, out, n_pad, f, tile, window, s);
  if (a_dtype == 1 && x_dtype == 1)
    return launch_bf16<bf16>(a, x, out, n_pad, f, tile, window, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
