// Persistent cooperative launches, shared by the BatchNorm epilogue's
// forward (epilogue_fwd.cu, row 2) and backward (epilogue_bwd.cu, row 3):
// a grid of co-resident blocks, each owning a contiguous range of rows,
// that meet at grid-wide barriers on a counter the caller keeps, one per
// stream, which every launch leaves at zero;
// the float conversions and rounding points of their arithmetic; V-wide
// vector accesses.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop {

constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use

// Barrier k of the launch: every block of the (co-resident) grid adds one
// to the counter (zero when the launch starts) and waits for it to reach
// k·grid, so every block arrives before any leaves; the block's writes
// before it are visible to every block after it (a release add on
// arrival, acquire loads while waiting; bar.sync orders the block's
// threads).  grid_arrive and grid_wait are its two halves, so that a
// block can work between them on what needs no other block.
__device__ __forceinline__ void grid_arrive(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void grid_wait(unsigned int* counter, unsigned int k) {
  if (threadIdx.x == 0) {
    const unsigned int want = k * gridDim.x;
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
    } while (v < want);
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_sync(unsigned int* counter, unsigned int k) {
  grid_arrive(counter);
  grid_wait(counter, k);
}

// The launch's last use of the counter, after its k-th (last) barrier:
// every block adds one, and the block that completes (k + 1)·grid clears
// it, so the next launch in the stream finds zero.  Each block adds only
// after it has left its last barrier, so no block waits on a cleared
// counter; a launch on another stream uses another counter.
__device__ __forceinline__ void grid_done(unsigned int* counter, unsigned int k) {
  if (threadIdx.x == 0 && atomicAdd(counter, 1u) == (k + 1u) * gridDim.x - 1u)
    atomicExch(counter, 0u);
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to T's precision (f32: as is)
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T in one access (4: 16 bytes in f32, 8 in bf16; or one)
template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T e[V];
};

// The block partition: at most `grid` blocks (and `max_grid`, what the
// caller's scratch holds, and one per `lanes` rows) share n rows in
// contiguous ranges of `rows`; grid 0 when nothing fits.
struct Partition {
  int grid, rows;
};

inline Partition partition(int n, int lanes, int grid, int max_grid) {
  const int by_rows = (n + lanes - 1) / lanes;
  grid = grid < by_rows ? grid : by_rows;
  grid = grid < max_grid ? grid : max_grid;
  if (grid < 1) return {0, 0};
  const int rows = (n + grid - 1) / grid;
  return {(n + rows - 1) / rows, rows};
}

// Launches `kernel` cooperatively (every block co-resident) in stream s.
// Its barrier counter must be zero, and the kernel leaves it so
// (grid_done): one counter a stream, kept by the caller.
template <typename K, typename A>
cudaError_t launch(K kernel, const A& args, int grid, int threads, size_t smem,
                   cudaStream_t s) {
  if (grid < 1 || smem > (size_t)SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace coop
