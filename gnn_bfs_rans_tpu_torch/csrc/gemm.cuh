// Tiled matrix products for the Transformer training path's projection
// (header only; the projection backward and the forward projections of
// rows 1 and 11 have their own, gemm_sm90.cuh).
//
//   C[m, n] = Σ_k A[m·lda + k] · B[k·ldb + n] (+ bias[n]),   f32 accumulate:
//
// the q/k/v projection and qw = q·wblk of transformer_project
// (banded_transformer.cu).
// An optional f32 bias (one per output column) is added to the f32 sum
// before the one rounding to C's type (the q/k/v projection).
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

#include "band_common.cuh"

namespace gemm {

using band::from_f;

// ------------------------------------------------------------ f32 (SIMT)
constexpr int PM = 128, PN = 128, PK = 8;

template <typename TO>
__global__ void __launch_bounds__(256) gemm_f32_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    TO* __restrict__ C, int ldc, int M, int N, int K,
    const float* __restrict__ bias) {
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
    // consecutive threads walk each operand's contiguous dimension
    for (int e = tid; e < PM * PK; e += 256) {
      const int mm = e / PK, kk = e % PK;
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? A[(size_t)gm * lda + gk] : 0.f;
    }
    for (int e = tid; e < PK * PN; e += 256) {
      const int nn = e % PN, kk = e / PN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? B[(size_t)gk * ldb + gn] : 0.f;
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
      if (gn < N)
        C[(size_t)gm * ldc + gn] =
            from_f<TO>(bias ? acc[i][j] + bias[gn] : acc[i][j]);
    }
  }
}

// ------------------------------------------------- bf16 (tensor cores)
constexpr int WM = 128, WN = 128, WK = 32, WPAD = 8;
constexpr int A_LD = WK + WPAD;   // A staged [rows][WK + WPAD]
constexpr int B_LD = WN + WPAD;   // B staged [WK][cols + WPAD]

// Two blocks per SM: the bound caps the registers at 128.  Unbounded, the
// z = x·W instance takes 161 and runs one block per SM, 76 µs per call
// against 55 µs bounded at N 12,032, F 256, H·C 1,024 on an H100
// (chip_smoke.py's profile).
template <typename TO>
__global__ void __launch_bounds__(256, 2) gemm_bf16_kernel(
    const __nv_bfloat16* __restrict__ A, int lda,
    const __nv_bfloat16* __restrict__ B, int ldb, TO* __restrict__ C, int ldc,
    int M, int N, int K, const float* __restrict__ bias) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[WM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[WK * B_LD];
  __shared__ __align__(32) float Cs[8][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * WM, n0 = blockIdx.x * WN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // 512 16-byte chunks per operand tile, 2 per thread.  Chunk e of A's
  // tile is row e/4, columns 8·(e%4)…; of B's tile k-row e/16, columns
  // 8·(e%16)….  The contiguous extent is a multiple of 8, so a chunk is
  // wholly in or out of range.
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      const int gm = m0 + e / 4, gka = k0 + (e % 4) * 8;
      ra[q] = (gm < M && gka < K)
                  ? *reinterpret_cast<const uint4*>(A + (size_t)gm * lda + gka)
                  : make_uint4(0u, 0u, 0u, 0u);
      const int gkb = k0 + e / 16, gn = n0 + (e % 16) * 8;
      rb[q] = (gn < N && gkb < K)
                  ? *reinterpret_cast<const uint4*>(B + (size_t)gkb * ldb + gn)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += WK) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + 256 * q;
      *reinterpret_cast<uint4*>(&As[(e / 4) * A_LD + (e % 4) * 8]) = ra[q];
      *reinterpret_cast<uint4*>(&Bs[(e / 16) * B_LD + (e % 16) * 8]) = rb[q];
    }
    __syncthreads();
    if (k0 + WK < K) load(k0 + WK);
#pragma unroll
    for (int kk = 0; kk < WK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[(wm * 64 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  // each warp stages one 16×16 f32 accumulator at a time to round it on
  // the store
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
          C[(size_t)gm * ldc + gn] = from_f<TO>(bias ? cs[e] + bias[gn] : cs[e]);
      }
      __syncwarp();
    }
  }
}

// C = A·B (+ bias).  Returns the launch's error code.
template <typename TO>
cudaError_t matmul(const float* A, int lda, const float* B, int ldb, TO* C,
                   int ldc, int M, int N, int K, cudaStream_t s,
                   const float* bias = nullptr) {
  dim3 grid((N + PN - 1) / PN, (M + PM - 1) / PM);
  gemm_f32_kernel<TO><<<grid, 256, 0, s>>>(A, lda, B, ldb, C, ldc, M, N, K,
                                           bias);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t matmul(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                   int ldb, TO* C, int ldc, int M, int N, int K,
                   cudaStream_t s, const float* bias = nullptr) {
  dim3 grid((N + WN - 1) / WN, (M + WM - 1) / WM);
  gemm_bf16_kernel<TO><<<grid, 256, 0, s>>>(A, lda, B, ldb, C, ldc, M, N, K,
                                            bias);
  return cudaGetLastError();
}

}  // namespace gemm
