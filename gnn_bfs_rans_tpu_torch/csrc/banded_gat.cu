// Fused-projection banded GAT forward with head-mean epilogue (eval form).
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded.py::
// banded_gat_mean_fused_fwd (_gat_kernel with fuse_proj=True,
// mean_heads=True; no dropout, no emit_stats, no emit_z).  Computes, for
// every receiver row i of tile t = i / T and every head h,
//
//   z      = x · W                          (f32 accumulate, rounded to x's dtype)
//   l[i,j] = LeakyReLU(α_dst[i,h] + α_src[s_j,h]),  s_j = t·T − (Wcols−T)/2 + j,
//            over the window columns j whose int8 band mask is 1
//   e      = exp(l − max_j l),   inv = 1 / max(Σ_j e, 1e-16)
//   out[i] = (Σ_h inv_h · Σ_j round(e_j) · z[s_j, h·C:(h+1)·C]) / H
//
// with round() the cast of the probability to bf16 when x is bf16 (the TPU
// kernel's _mm_cast) and the identity in f32.  Sender rows outside
// [0, n_pad) are absent: never read (their mask entries are 0 anyway).
//
// What bounds it on an H100: the projection, 2·N·F·H·C operations (6.3
// GFLOP per layer at N 12,032, F 256, H 4, C 256), is the only dense work.
// The attention is a sparse product: the band mask holds ~5 entries per row
// of 256-640 columns, so the work this data needs is 2·nnz·H·C operations.
// The TPU kernel computes the whole [T, Wcols] plane because its matrix unit
// has no gather; here one warp per receiver row compacts the row's mask to
// its nonzero columns (a ballot), computes only those logits, and gathers
// only those z rows, so the dense plane is never formed.  The projection is
// a shared-memory-tiled GEMM: on the tensor cores (warp mma, f32
// accumulate) in bf16, and in true f32 FMA on the SIMT units in f32 (the f32
// path must not use TF32, matching the TPU kernel's Precision.HIGHEST).
// Unlike the TPU kernel, z makes one round trip through device memory
// (N·H·C·dtype bytes: 24.6 MB per layer at the flagship shape in bf16);
// keeping z on chip, and wgmma/TMA for the projection, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The probability as the aggregation matmul sees it (TPU _mm_cast).
template <typename T> __device__ __forceinline__ float mm_round(float v);
template <> __device__ __forceinline__ float mm_round<float>(float v) { return v; }
template <> __device__ __forceinline__ float mm_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------- projection
// z[M, N] = x[M, K] · w[K, N].  f32: SIMT FMA (no TF32); 128×128 output tile
// per block, 256 threads, 8×8 outputs per thread (rows ty + 16·i, columns
// tx + 16·j).
constexpr int PM = 128, PN = 128, PK = 8;

template <typename T>
__global__ void __launch_bounds__(256) project_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ z,
    int M, int K, int N) {
  __shared__ float As[PK][PM];
  __shared__ float Bs[PK][PN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += PK) {
    for (int e = tid; e < PM * PK; e += 256) {
      const int mm = e / PK, kk = e % PK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < PK * PN; e += 256) {
      const int kk = e / PN, nn = e % PN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? to_f(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) z[(size_t)gm * N + gn] = from_f<T>(acc[i][j]);
    }
  }
}

// bf16 projection on the tensor cores (warp-level mma through nvcuda::wmma,
// 16×16×16 bf16 fragments, f32 accumulate).  128×128 output tile per block,
// 8 warps as 2 (rows) × 4 (columns), 64×32 per warp; K advances 32 at a
// time through padded shared-memory tiles filled with 16-byte loads (K and
// N must be multiples of 8).  Each warp stages one 16×16 f32
// accumulator at a time in shared memory to round it to bf16 on the store.
constexpr int WM = 128, WN = 128, WK = 32, WPAD = 8;

__global__ void __launch_bounds__(256) project_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ z, int M, int K, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[WM][WK + WPAD];
  __shared__ __align__(32) __nv_bfloat16 Bs[WK][WN + WPAD];
  __shared__ __align__(32) float Cs[8][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // 16-byte chunks: each thread moves 2 of the A tile's 512 and 2 of the B
  // tile's 512 per K step; the next step's chunks are loaded into registers
  // while the tensor cores work on the current one (K and N are multiples
  // of 8, checked by the wrapper, so a chunk is wholly in or out of range)
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      const int gm = m0 + e / (WK / 8), gk = k0 + (e % (WK / 8)) * 8;
      ra[q] = (gm < M && gk < K)
                  ? *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk)
                  : make_uint4(0u, 0u, 0u, 0u);
      const int bk = k0 + e / (WN / 8), gn = n0 + (e % (WN / 8)) * 8;
      rb[q] = (bk < K && gn < N)
                  ? *reinterpret_cast<const uint4*>(w + (size_t)bk * N + gn)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += WK) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      *reinterpret_cast<uint4*>(&As[e / (WK / 8)][(e % (WK / 8)) * 8]) = ra[q];
      *reinterpret_cast<uint4*>(&Bs[e / (WN / 8)][(e % (WN / 8)) * 8]) = rb[q];
    }
    __syncthreads();
    if (k0 + WK < K) load(k0 + WK);
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 64 + i * 16][kk], WK + WPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], WN + WPAD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm * 64 + i * 16 + e / 16;
        const int gn = n0 + wn * 32 + j * 16 + e % 16;
        if (gm < M && gn < N) z[(size_t)gm * N + gn] = __float2bfloat16_rn(cs[e]);
      }
      __syncwarp();
    }
  }
}

void project(const float* x, const float* w, float* z, int M, int K, int N,
             cudaStream_t stream) {
  dim3 grid((N + PN - 1) / PN, (M + PM - 1) / PM);
  project_kernel<float><<<grid, 256, 0, stream>>>(x, w, z, M, K, N);
}

void project(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* z,
             int M, int K, int N, cudaStream_t stream) {
  dim3 grid((N + WN - 1) / WN, (M + WM - 1) / WM);
  project_bf16_kernel<<<grid, 256, 0, stream>>>(x, w, z, M, K, N);
}

// ----------------------------------------------------------------- attention
// One warp per receiver row, 8 rows per block; blockIdx.y picks a chunk of
// 256 output columns.  A lane covers 4 adjacent columns in each of 2 groups
// (4·lane + 128·g + q), read and written as one 8-byte (bf16) or 16-byte
// (f32) access; C must be a multiple of 4.  Per warp, shared memory holds
// the row's compacted sender list and its probabilities.
constexpr int ROWS_PER_BLOCK = 8;
constexpr int GROUPS = 2;
constexpr int COLS_PER_LANE = 4 * GROUPS;
constexpr int COL_CHUNK = 32 * COLS_PER_LANE;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) gat_attention_kernel(
    const int8_t* __restrict__ mask,    // [n_tiles, T, Wcols]
    const float* __restrict__ alphas,   // [n_pad, 2H]: src | dst
    const T* __restrict__ z,            // [n_pad, H·C]
    T* __restrict__ out,                // [n_pad, C]
    int n_pad, int heads, int C, int tile, int wcols, float slope) {
  extern __shared__ unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= n_pad) return;  // whole warp: no block-wide barrier below
  int* idx = reinterpret_cast<int*>(smem) + warp * 2 * wcols;
  float* pw = reinterpret_cast<float*>(idx + wcols);

  const int t = row / tile;
  const int s0 = t * tile - (wcols - tile) / 2;
  const int8_t* mrow = mask + (size_t)row * wcols;  // [t, row % T] row

  // compact the mask row to its in-range nonzero sender rows (in order)
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

  const int hc = heads * C;
  const int two_h = 2 * heads;
  const int c_base = blockIdx.y * COL_CHUNK;
  float total[COLS_PER_LANE];
#pragma unroll
  for (int j = 0; j < COLS_PER_LANE; ++j) total[j] = 0.f;

  for (int h = 0; h < heads; ++h) {
    const float ad = alphas[(size_t)row * two_h + heads + h];
    float mx = -CUDART_INF_F;
    for (int k = lane; k < cnt; k += 32) {
      float a = ad + alphas[(size_t)idx[k] * two_h + h];
      a = a >= 0.f ? a : slope * a;
      pw[k] = a;
      mx = fmaxf(mx, a);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < cnt; k += 32) {
      const float e = expf(pw[k] - mx);
      sum += e;
      pw[k] = mm_round<T>(e);
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.f / fmaxf(sum, 1e-16f);

    float acc[COLS_PER_LANE];
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) acc[j] = 0.f;
    for (int k = 0; k < cnt; ++k) {
      const float p = pw[k];
      const T* zr = z + (size_t)idx[k] * hc + (size_t)h * C;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const int c = c_base + 4 * lane + 128 * g;
        if (c < C) {
          float v[4];
          load4(zr + c, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[4 * g + q] = fmaf(p, v[q], acc[4 * g + q]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) total[j] += acc[j] * inv;
    __syncwarp();  // pw is rewritten by the next head
  }

  const float inv_heads = 1.f / (float)heads;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int c = c_base + 4 * lane + 128 * g;
    if (c < C) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = total[4 * g + q] * inv_heads;
      store4(out + (size_t)row * C + c, v);
    }
  }
}

template <typename T>
int launch(const int8_t* mask, const void* w, const float* alphas,
           const void* x, void* z, void* out, int n_pad, int f, int heads,
           int c, int tile, int wcols, float slope, cudaStream_t stream) {
  project(static_cast<const T*>(x), static_cast<const T*>(w),
          static_cast<T*>(z), n_pad, f, heads * c, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 agrid((n_pad + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
             (c + COL_CHUNK - 1) / COL_CHUNK);
  const size_t smem = (size_t)ROWS_PER_BLOCK * wcols * (sizeof(int) + sizeof(float));
  gat_attention_kernel<T><<<agrid, 32 * ROWS_PER_BLOCK, smem, stream>>>(
      mask, alphas, static_cast<const T*>(z), static_cast<T*>(out), n_pad,
      heads, c, tile, wcols, slope);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, z and out share it).  z is the
// caller-allocated [n_pad, heads·c] projection scratch.  Returns the CUDA
// error code of the launches (0 on success).
int banded_gat_mean_fused_launch(const int8_t* mask, const void* w,
                                 const float* alphas, const void* x, void* z,
                                 void* out, int n_pad, int f, int heads, int c,
                                 int tile, int wcols, float slope, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(mask, w, alphas, x, z, out, n_pad, f, heads, c, tile,
                         wcols, slope, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(mask, w, alphas, x, z, out, n_pad, f, heads,
                                 c, tile, wcols, slope, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
