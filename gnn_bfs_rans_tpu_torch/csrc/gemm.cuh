// Tiled matrix products for the kernels of this package (header only).
//
//   C[m, n] = Σ_k A(m, k) · B(k, n) (+ bias[n]),   f32 accumulate,
//
// with each operand contiguous along one of its two dimensions:
//   A_KC: A(m, k) = A[m·lda + k]   else A(m, k) = A[k·lda + m]
//   B_KC: B(k, n) = B[n·ldb + k]   else B(k, n) = B[k·ldb + n]
// so the one kernel serves z = x·W (banded_gat.cu), dx = dz·Wᵀ and
// dW = xᵀ·dz (fold_project_bwd.cu) without transposed copies.  blockIdx.z splits
// K into chunks of k_chunk rows; chunk z writes its own output slice at
// C + z·c_split (the caller folds the slices in a fixed order, so a
// reduction over K stays deterministic).  An optional f32 bias (one per
// output column) is added to the f32 sum before the one rounding to C's
// type (banded_transformer.cu's q/k/v projections).  An optional colsum
// pointer takes the f32 column sums of B over each chunk's K rows, summed
// from the B tiles the blocks of the first row of output tiles already
// stage, chunk z's at colsum + z·c_split (fold_project_bwd.cu's bias
// gradient db = Σ_rows dz).
//
// bf16 inputs run on the tensor cores (warp-level mma through nvcuda::wmma,
// 16×16×16 bf16 fragments): a 128×128 output tile per block, 8 warps as
// 2 (rows) × 4 (columns), 64×32 per warp, K advancing 32 at a time through
// padded shared-memory tiles filled with 16-byte loads along each operand's
// contiguous dimension (that dimension must be a multiple of 8 and the base
// 16-byte aligned; the wrappers check).  The next K step's chunks are loaded
// into registers while the tensor cores work on the current one.  f32 inputs
// run in true f32 FMA on the SIMT units (no TF32: the TPU kernels use
// Precision.HIGHEST for f32), 8×8 outputs per thread.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "band_common.cuh"

namespace gemm {

using band::from_f;

// ------------------------------------------------------------ f32 (SIMT)
constexpr int PM = 128, PN = 128, PK = 8;

template <typename TO, bool A_KC, bool B_KC>
__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    TO* __restrict__ C, int ldc, long long c_split, int M, int N, int K,
    int k_chunk, const float* __restrict__ bias, float* __restrict__ colsum) {
  __shared__ float As[PK][PM];
  __shared__ float Bs[PK][PN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * PM, n0 = blockIdx.x * PN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const bool sums = colsum != nullptr && blockIdx.y == 0 && tid < PN;
  float csum = 0.f;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += PK) {
    // consecutive threads walk each operand's contiguous dimension
    for (int e = tid; e < PM * PK; e += 256) {
      const int mm = A_KC ? e / PK : e % PM, kk = A_KC ? e % PK : e / PM;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < kend)
                       ? (A_KC ? A[(size_t)gm * lda + gk] : A[(size_t)gk * lda + gm])
                       : 0.f;
    }
    for (int e = tid; e < PK * PN; e += 256) {
      const int nn = B_KC ? e / PK : e % PN, kk = B_KC ? e % PK : e / PN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < kend && gn < N)
                       ? (B_KC ? B[(size_t)gn * ldb + gk] : B[(size_t)gk * ldb + gn])
                       : 0.f;
    }
    __syncthreads();
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) csum += Bs[kk][tid];
    }
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
  if (sums && n0 + tid < N) colsum[(size_t)blockIdx.z * c_split + n0 + tid] = csum;
  TO* out = C + (size_t)blockIdx.z * c_split;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[(size_t)gm * ldc + gn] =
            from_f<TO>(bias ? acc[i][j] + bias[gn] : acc[i][j]);
    }
  }
}

// ------------------------------------------------- bf16 (tensor cores)
constexpr int WM = 128, WN = 128, WK = 32, WPAD = 8;
// shared tiles: a K-contiguous operand is staged [rows][WK + WPAD], an
// M/N-contiguous one [WK][cols + WPAD]
constexpr int KC_TILE = 128 * (WK + WPAD);
constexpr int RC_TILE = WK * (128 + WPAD);

// Two blocks per SM: the bound caps the registers at 128.  Unbounded, the
// z = x·W instance takes 161 and runs one block per SM, 76 µs per call
// against 55 µs bounded at N 12,032, F 256, H·C 1,024 on an H100
// (chip_smoke.py's profile).
template <typename TO, bool A_KC, bool B_KC>
__global__ void __launch_bounds__(256, 2) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, int lda,
    const __nv_bfloat16* __restrict__ B, int ldb, TO* __restrict__ C, int ldc,
    long long c_split, int M, int N, int K, int k_chunk,
    const float* __restrict__ bias, float* __restrict__ colsum) {
  using namespace nvcuda;
  using ALayout = typename std::conditional<A_KC, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<B_KC, wmma::col_major, wmma::row_major>::type;
  constexpr int A_LD = A_KC ? WK + WPAD : WM + WPAD;
  constexpr int B_LD = B_KC ? WK + WPAD : WN + WPAD;
  __shared__ __align__(32) __nv_bfloat16 As[A_KC ? KC_TILE : RC_TILE];
  __shared__ __align__(32) __nv_bfloat16 Bs[B_KC ? KC_TILE : RC_TILE];
  __shared__ __align__(32) float Cs[8][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const bool sums = colsum != nullptr && blockIdx.y == 0 && tid < WN;
  float csum = 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // 512 16-byte chunks per operand tile, 2 per thread.  Chunk e of a
  // K-contiguous tile is row e/4, columns 8·(e%4)…; of an M/N-contiguous
  // tile k-row e/16, columns 8·(e%16)….  The contiguous extent is a
  // multiple of 8, so a chunk is wholly in or out of range.
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      if (A_KC) {
        const int gm = m0 + e / 4, gk = k0 + (e % 4) * 8;
        ra[q] = (gm < M && gk < kend)
                    ? *reinterpret_cast<const uint4*>(A + (size_t)gm * lda + gk)
                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        const int gk = k0 + e / 16, gm = m0 + (e % 16) * 8;
        ra[q] = (gm < M && gk < kend)
                    ? *reinterpret_cast<const uint4*>(A + (size_t)gk * lda + gm)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
      if (B_KC) {
        const int gn = n0 + e / 4, gk = k0 + (e % 4) * 8;
        rb[q] = (gn < N && gk < kend)
                    ? *reinterpret_cast<const uint4*>(B + (size_t)gn * ldb + gk)
                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        const int gk = k0 + e / 16, gn = n0 + (e % 16) * 8;
        rb[q] = (gn < N && gk < kend)
                    ? *reinterpret_cast<const uint4*>(B + (size_t)gk * ldb + gn)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  load(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += WK) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      const int ao = A_KC ? (e / 4) * A_LD + (e % 4) * 8 : (e / 16) * A_LD + (e % 16) * 8;
      const int bo = B_KC ? (e / 4) * B_LD + (e % 4) * 8 : (e / 16) * B_LD + (e % 16) * 8;
      *reinterpret_cast<uint4*>(&As[ao]) = ra[q];
      *reinterpret_cast<uint4*>(&Bs[bo]) = rb[q];
    }
    __syncthreads();
    if (k0 + WK < kend) load(k0 + WK);
    if (sums) {
#pragma unroll 8
      for (int kk = 0; kk < WK; ++kk)
        csum += __bfloat162float(B_KC ? Bs[tid * B_LD + kk] : Bs[kk * B_LD + tid]);
    }
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16;
        wmma::load_matrix_sync(a[i], A_KC ? &As[r * A_LD + kk] : &As[kk * A_LD + r], A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + j * 16;
        wmma::load_matrix_sync(b[j], B_KC ? &Bs[c * B_LD + kk] : &Bs[kk * B_LD + c], B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (sums && n0 + tid < N) colsum[(size_t)blockIdx.z * c_split + n0 + tid] = csum;
  // each warp stages one 16×16 f32 accumulator at a time to round it on
  // the store
  TO* out = C + (size_t)blockIdx.z * c_split;
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
        if (gm < M && gn < N)
          out[(size_t)gm * ldc + gn] = from_f<TO>(bias ? cs[e] + bias[gn] : cs[e]);
      }
      __syncwarp();
    }
  }
}

// C (or its K-split slices) = A·B; k_chunk ≥ K means one slice.  Returns
// the launch's error code.
template <bool A_KC, bool B_KC, typename TO>
cudaError_t matmul(const float* A, int lda, const float* B, int ldb, TO* C,
                   int ldc, long long c_split, int M, int N, int K, int k_chunk,
                   cudaStream_t s, const float* bias = nullptr,
                   float* colsum = nullptr) {
  dim3 grid((N + PN - 1) / PN, (M + PM - 1) / PM, (K + k_chunk - 1) / k_chunk);
  gemm_f32_kernel<TO, A_KC, B_KC><<<grid, 256, 0, s>>>(
      A, lda, B, ldb, C, ldc, c_split, M, N, K, k_chunk, bias, colsum);
  return cudaGetLastError();
}

template <bool A_KC, bool B_KC, typename TO>
cudaError_t matmul(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                   int ldb, TO* C, int ldc, long long c_split, int M, int N,
                   int K, int k_chunk, cudaStream_t s,
                   const float* bias = nullptr, float* colsum = nullptr) {
  dim3 grid((N + WN - 1) / WN, (M + WM - 1) / WM, (K + k_chunk - 1) / k_chunk);
  gemm_bf16_kernel<TO, A_KC, B_KC><<<grid, 256, 0, s>>>(
      A, lda, B, ldb, C, ldc, c_split, M, N, K, k_chunk, bias, colsum);
  return cudaGetLastError();
}

}  // namespace gemm
