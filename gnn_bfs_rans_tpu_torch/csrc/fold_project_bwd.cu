// Projection backward: dx = dz·Wᵀ, dW = xᵀ·dz and, in the bias form,
// db = Σ_rows dz.
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded_bwd.py::
// fold_project_bwd (_fold_project_kernel, with_bias False and True).  The
// TPU kernel first folds the attention backward's window partials into dz
// tiles in VMEM; the port's GAT backward (banded_gat_bwd.cu) emits dz rows
// and its Transformer backward has its partials folded by fold_partials.cu,
// so this kernel is the projection backward over dz rows.  Both products
// run in this kernel's own body on the tensor cores in bf16 (gemm.cuh, f32
// accumulate; dx rounded to x's dtype) and in true f32 FMA in f32:
//
//   dx [N, F]  = dz [N, H·C] · W [F, H·C]ᵀ       (one K = H·C slice)
//   dW [F, H·C] = Σ_z x[K_z]ᵀ · dz[K_z]          (f32)
//   db [H·C]    = Σ_z Σ_{rows of K_z} dz         (f32, bias form)
//
// dW is a reduction over the N rows: blockIdx.z takes one chunk K_z of
// rows and writes its own f32 slice; fold_splits_kernel then sums the
// slices in chunk order, so dW is deterministic (no atomics).  The bias
// form sums each chunk's dz columns from the dz tiles the dW product
// already stages (gemm.cuh's colsum), into row F of the chunk's slice, so
// the same fold gives db.  x may be a column block of a wider buffer (row
// stride ldx): the Transformer's dwblk = qᵀ·dqw reads q from its q|k|v
// buffer.
//
// What bounds it on an H100: at N 12,032, F 256, H·C 1,024 in bf16 the
// products are 4·N·F·H·C = 12.6 GFLOP, 12.8 µs at 989 TFLOP/s, against
// dz 24.6 MB + x 6.2 MB + W 0.5 MB read and dx 6.2 MB + dW 1 MB written,
// ~38.5 MB, 11.5 µs at 3.35 TB/s: about balanced.  The slices add
// splits·(F + 1)·H·C·4 bytes written and read again.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace {

__global__ void fold_splits_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int splits,
                                   long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[z * n + i];
    out[i] = acc;
  }
}

template <typename T>
int launch(const void* dz_, const void* x_, int ldx, const void* w_, void* dx_,
           float* dw, float* part, int n, int f, int hc, int k_chunk,
           int with_bias, cudaStream_t s) {
  const T* dz = static_cast<const T*>(dz_);
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  // dx: A = dz (K-contiguous, lda H·C), B(k, n) = W[n·H·C + k] (K-contiguous)
  cudaError_t err = gemm::matmul<true, true>(dz, hc, w, hc, static_cast<T*>(dx_),
                                             f, 0, n, f, hc, hc, s);
  if (err != cudaSuccess) return (int)err;
  // dW slices [F (+1 bias row), H·C]: A(m, k) = x[k·ldx + m] (M-contiguous),
  // B = dz (N-contiguous)
  const int rows = f + (with_bias ? 1 : 0);
  const long long slice = (long long)rows * hc;
  err = gemm::matmul<false, false>(x, ldx, dz, hc, part, hc, slice, f, hc, n,
                                   k_chunk, s, nullptr,
                                   with_bias ? part + (size_t)f * hc : nullptr);
  if (err != cudaSuccess) return (int)err;
  const int splits = (n + k_chunk - 1) / k_chunk;
  fold_splits_kernel<<<(int)((slice + 255) / 256 < 1024 ? (slice + 255) / 256 : 1024),
                       256, 0, s>>>(part, dw, splits, slice);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dz, x, w and dx share it; dw is f32).
// ldx: the row stride of x.  with_bias: dw is [f + 1, hc], its last row db.
// part is the caller-allocated [ceil(n / k_chunk), f (+1), hc] f32 scratch.
// Returns the CUDA error code of the launches (0 on success).
int fold_project_bwd_launch(const void* dz, const void* x, int ldx,
                            const void* w, void* dx, float* dw, float* part,
                            int n, int f, int hc, int k_chunk, int with_bias,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dz, x, ldx, w, dx, dw, part, n, f, hc, k_chunk,
                         with_bias, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dz, x, ldx, w, dx, dw, part, n, f, hc,
                                 k_chunk, with_bias, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
