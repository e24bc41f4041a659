// Projection backward: dx = dz·Wᵀ, dW = xᵀ·dz and, in the bias form,
// db = Σ_rows dz.
//
// Replaces the TPU kernel gnn_bfs_rans_tpu/kernels/banded_bwd.py::
// fold_project_bwd (_fold_project_kernel, with_bias False and True).  The
// TPU kernel first folds the attention backward's window partials into dz
// tiles in VMEM; the port's GAT backward (banded_gat_bwd.cu) emits dz rows
// and its Transformer backward has its partials folded by fold_partials.cu,
// so this kernel is the projection backward over dz rows.  Both products
// run in one persistent launch (gemm_sm90.cuh): wgmma on TMA-fed tiles in
// bf16 (f32 accumulate; dx rounded once to x's dtype), true f32 FMA on the
// SIMT units in f32:
//
//   dx [N, F]   = dz [N, H·C] · W [F, H·C]ᵀ
//   dW [F, H·C] = Σ_z x[K_z]ᵀ · dz[K_z]          (f32)
//   db [H·C]    = Σ_z Σ_{rows of K_z} dz         (f32, bias form)
//
// dW is a reduction over the N rows: each K-chunk K_z writes its own f32
// slice ([F (+1), H·C], row F the bias form's column sums of the dz tiles
// the dW product stages); fold_kernel then sums the slices in chunk order,
// so dW and db are deterministic (no atomics).  With one chunk the product
// writes dW directly.  x may be a column block of a wider buffer (row
// stride ldx): the Transformer's dwblk = qᵀ·dqw reads q from its q|k|v
// buffer.  The chunk count and each block's items come from the caller's
// plan (kernels/banded_bwd.py::_plan), sized for the card's SMs.
//
// What bounds it on an H100: at N 12,032, F 256, H·C 1,024 in bf16 the
// products are 4·N·F·H·C = 12.6 GFLOP, 12.8 µs at 989 TFLOP/s, against
// dz 24.6 MB + x 6.2 MB + W 0.5 MB read and dx 6.2 MB + dW 1 MB written,
// ~38.5 MB, 11.5 µs at 3.35 TB/s: about balanced.  dz is read twice (once
// per product) and the slices add splits·(F + 1)·H·C·4 bytes written and
// read again (9 slices, 9.4 MB, at that shape), mostly in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

using namespace sm90;

namespace {

// the work list of one call; the tile shapes mirror _TILES in
// kernels/banded_bwd.py
Work make_work(int n, int f, int hc, int splits, int chunk, const int* sched,
               int bxm, int bxn, int bxk, int bwm, int bwn, int bwk) {
  Work p;
  p.dx_tm = (n + bxm - 1) / bxm;
  p.dx_tn = (f + bxn - 1) / bxn;
  p.dx_steps = (hc + bxk - 1) / bxk;
  p.dw_tm = (f + bwm - 1) / bwm;
  p.dw_tn = (hc + bwn - 1) / bwn;
  p.dw_steps = (n + bwk - 1) / bwk;
  p.splits = splits;
  p.chunk = chunk;
  p.sched = sched;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dz, x, w and dx share it; dw is f32).
// ldx: the row stride of x.  with_bias: dw is [f + 1, hc], its last row db.
// part: the caller-allocated [splits, f (+1), hc] f32 scratch (dw itself
// when splits is 1).  The plan: splits, chunk (K steps per chunk), grid,
// sched (device int32 [grid + 1 + items]: block b runs the items
// sched[grid + 1 + i], i in [sched[b], sched[b + 1])) and dx_cols (the
// bf16 dx tile's columns, 128 or 256, when H·C is a multiple of 64).  Returns the CUDA error code of the launches (0 on success).
int fold_project_bwd_launch(const void* dz, const void* x, int ldx,
                            const void* w, void* dx, float* dw, float* part,
                            int n, int f, int hc, int with_bias, int dtype,
                            int splits, int chunk, const int* sched,
                            int grid, int dx_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slice = (long long)(f + (with_bias ? 1 : 0)) * hc;
  cudaError_t err;
  if (dtype == 1) {
    const Out<__nv_bfloat16> o{static_cast<__nv_bfloat16*>(dx), part, slice,
                               n, f, hc, with_bias};
    const auto* pdz = static_cast<const __nv_bfloat16*>(dz);
    const auto* px = static_cast<const __nv_bfloat16*>(x);
    const auto* pw = static_cast<const __nv_bfloat16*>(w);
    if (hc % 64 == 0 && dx_cols == DxHalf::BN) {
      const Work p = make_work(n, f, hc, splits, chunk, sched, DxHalf::BM,
                               DxHalf::BN, DxHalf::BK, DwWide::BM, DwWide::BN,
                               DwWide::BK);
      if ((long long)splits * chunk < p.dw_steps) return (int)cudaErrorInvalidValue;
      err = run_bf16<DxHalf, DwWide>(pdz, px, ldx, pw, p, grid, o, s);
    } else if (hc % 64 == 0) {
      const Work p = make_work(n, f, hc, splits, chunk, sched, DxWide::BM,
                               DxWide::BN, DxWide::BK, DwWide::BM, DwWide::BN,
                               DwWide::BK);
      if ((long long)splits * chunk < p.dw_steps) return (int)cudaErrorInvalidValue;
      err = run_bf16<DxWide, DwWide>(pdz, px, ldx, pw, p, grid, o, s);
    } else {
      if (with_bias) return (int)cudaErrorInvalidValue;
      const Work p = make_work(n, f, hc, splits, chunk, sched, DxNarrow::BM,
                               DxNarrow::BN, DxNarrow::BK, DwNarrow::BM,
                               DwNarrow::BN, DwNarrow::BK);
      if ((long long)splits * chunk < p.dw_steps) return (int)cudaErrorInvalidValue;
      err = run_bf16<DxNarrow, DwNarrow>(pdz, px, ldx, pw, p, grid, o, s);
    }
  } else if (dtype == 0) {
    const Out<float> o{static_cast<float*>(dx), part, slice, n, f, hc,
                       with_bias};
    const Work p = make_work(n, f, hc, splits, chunk, sched, f32::BM,
                             f32::BN, f32::BK, f32::BM, f32::BN, f32::BK);
    if ((long long)splits * chunk < p.dw_steps) return (int)cudaErrorInvalidValue;
    const f32::Args a{static_cast<const float*>(dz),
                      static_cast<const float*>(x), ldx,
                      static_cast<const float*>(w)};
    f32::proj_bwd_f32_kernel<<<grid, f32::THREADS, 0, s>>>(a, p, o);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n4 = slice / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  fold_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                     reinterpret_cast<float4*>(dw), splits, n4);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
