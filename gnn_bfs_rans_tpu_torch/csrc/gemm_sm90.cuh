// Matrix products on Hopper (header only): the projection backward
// (fold_project_bwd.cu), and the forward projection of the Transformer's
// q/k/v (row 11 and the training path's transformer_project,
// banded_transformer.cu) and row 1's z (banded_gat.cu).
//
// The projection backward: one persistent launch computes both products
//
//   dx [N, F]   = dz [N, H·C] · W [F, H·C]ᵀ     (rounded once to dx's dtype)
//   dW [F, H·C] = Σ_z x[K_z]ᵀ · dz[K_z]          (f32 partial per K-chunk z)
//   db [H·C]    = Σ_z Σ_{rows of K_z} dz          (f32, bias form)
//
// as a list of work items: dx's output tiles and dW's (output tile, K-chunk)
// pairs.  A grid of at most one block per SM (two in f32) runs them; the
// caller hands each block its items (kernels/banded_bwd.py::_plan: the
// chunk count, and the items costed by the bytes they move, dealt in
// rounds in bf16 and longest first to the least loaded block in f32), so
// that dx's ragged last wave is filled by dW's chunks.  Each dW chunk
// writes its own f32 slice;
// fold_kernel sums the slices in chunk order, so dW and db are
// deterministic (no atomics).
//
// bf16: TMA (cp.async.bulk.tensor, 128-byte swizzle) fills a ring of four
// 48 KB stages in shared memory, driven by one producer thread behind
// mbarriers; two consumer warpgroups run wgmma.mma_async on 64-row tiles
// with f32 accumulators in registers (setmaxnreg moves registers from the
// producer warpgroup to them).  wgmma reads both operands from shared memory
// K-major (dx: dz and W) or MN-major (dW: x and dz), so neither product needs
// a transposed copy.  Tiles: dx 128 × 256 (the whole F = 256 row block, so a
// dz larger than half the L2 is read once for dx) or 128 × 128 (a smaller
// dz: twice the items to balance, the second read from L2), dW 256 × 128
// (m64n64 wgmmas; m64n128, tried, ran no faster); H·C not a multiple of 64
// takes the narrow forms (dx's K in steps of 16, dW 256 × 16: the
// Transformer's dqw [N, H·4] against wblk).  TMA zero-fills the ragged edges (N, F, H·C);
// the stores are masked.  The TMA descriptors come from
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no -lcuda).
//
// f32: true f32 FMA on the SIMT units (the TPU kernels use
// Precision.HIGHEST; no TF32): 128 × 128 × 16 tiles, cp.async double
// buffering with 16-byte loads along each operand's contiguous dimension,
// fragments read from shared memory as float4, the same items and fold.
//
// The forward projection (namespace fwd, and f32::proj_fwd_f32_kernel):
//
//   out [N, nw·H·C] = x [N, F] · [W0 | … | W(nw−1)] (+ [b0 | … ])
//
// for nw 3 (the Transformer's q|k|v, with the biases) or 1 (row 1's z, no
// bias), from the weights [F, H·C] as they are (one TMA map each, no
// concatenated copy), f32 accumulate, the bias (x's dtype) added in f32,
// one rounding to x's dtype.  The training path also asks for qw = q·wblk
// ([N, H·4], wblk block-diagonal [H·C, H·4]): in bf16, when C is a
// multiple of 16 dividing the 256-column tile, each q tile's epilogue
// forms it from the rounded tile it has staged in shared memory
// (mma.m16n8k16 over k16 chunks, one rounding), so q is not read again.
// bf16: one persistent launch, at most one
// block per SM, walking output tiles of 128 rows × 256 columns of one
// weight (one head of q, k, v or z at C 256), column tile fastest so the
// blocks running at once share x's rows in L2; x K-major (row 6's dx
// operand), W MN-major (row 6's dW operand), m64n256 wgmmas through a
// three-stage ring; the tile is staged in shared memory and written by TMA
// stores (whole 128-byte lines, the ragged N and H·C edges dropped by
// TMA), which drain while the consumers run the next tile and the producer
// loads it.
// f32: one 128 × 128 tile of one weight per block, row 6's SIMT tiles with
// x K-major and W MN-major.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ------------------------------------------------------------ the plan
// The work list both dtypes share.  Items: dx tiles (dx_tm × dx_tn, each
// dx_steps K steps; item ids 0 … dx_tm·dx_tn − 1) and dW (tile, chunk)
// pairs (dw_tm × dw_tn × splits, each at most `chunk` of the dw_steps K
// steps over all N rows; the ids after them).  sched: block b runs items
// sched[grid + 1 + i] for i in [sched[b], sched[b + 1]).
struct Work {
  int dx_tm, dx_tn, dx_steps;
  int dw_tm, dw_tn, dw_steps;
  int splits, chunk;
  const int* sched;
};

struct Item {
  bool w;         // a dW chunk (else a dx tile)
  int tm, tn, z, k0, k1;
};

// dx tiles column-fastest (they share dz's rows); dW chunks column-fastest,
// then row tile, then chunk
__device__ __forceinline__ Item decode(const Work& p, int idx) {
  const int n_x = p.dx_tm * p.dx_tn;
  Item it;
  it.w = idx >= n_x;
  int j = it.w ? idx - n_x : idx;
  if (it.w) {
    it.tn = j % p.dw_tn;
    j /= p.dw_tn;
    it.tm = j % p.dw_tm;
    it.z = j / p.dw_tm;
    it.k0 = it.z * p.chunk;
    it.k1 = min(p.dw_steps, it.k0 + p.chunk);
  } else {
    it.tn = j % p.dx_tn;
    it.tm = j / p.dx_tn;
    it.z = 0;
    it.k0 = 0;
    it.k1 = p.dx_steps;
  }
  return it;
}

// the outputs: dx [n, f] (ld f), the dW slices part + z·slice ([f (+1), hc],
// row f the bias form's column sums)
template <typename T>
struct Out {
  T* dx;
  float* part;
  long long slice;
  int n, f, hc, bias;
};

// dW slices summed in chunk order (float4: hc is a multiple of 4)
__global__ void fold_kernel(const float4* __restrict__ part,
                            float4* __restrict__ out, int splits,
                            long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 acc = part[i];
    for (int z = 1; z < splits; ++z) {
      const float4 v = part[z * n4 + i];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    out[i] = acc;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------ mbarriers, TMA, wgmma
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// a 2-D box at (c0 inner, c1 outer) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across the async ops
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t sw) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)(sw == 128 ? 1 : sw == 64 ? 2 : 3) << 62);
}

// The descriptor of one wgmma operand inside a tile that TMA wrote with a
// SW-byte swizzle, at MN offset mn0 and K step kk (16 values):
//  K-major: rows of SW bytes (BK values), 8-row groups 8·SW apart; a K step
//    advances 32 bytes inside the swizzled row;
//  MN-major: atoms of SW/2 MN values × BK rows (SW·BK bytes, one TMA box
//    each), 8-row groups 8·SW apart; a K step advances 16 rows.  Every
//    wgmma here spans one atom in MN, so the leading offset is never read.
template <int SW, bool MN, int BK>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int mn0,
                                                 int kk) {
  if (MN)
    return make_desc(base + (mn0 / (SW / 2)) * (SW * BK) + kk * 16 * SW,
                     SW * BK, 8 * SW, SW);
  return make_desc(base + mn0 * SW + kk * 32, 16, 8 * SW, SW);
}

// D[64, 256] += A[64, 16]·B[16, 256]; TA / TB: 0 K-major, 1 MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n256k16(float (&d)[128], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D[64, 64] += A[64, 16]·B[16, 64]; TA / TB: 0 K-major, 1 MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D[64, 16] += A[64, 16]·B[16, 16]; TA / TB: 0 K-major, 1 MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n16k16(float (&d)[8], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


// D[64, 128] += A[64, 16]·B[16, 128]; TA / TB: 0 K-major, 1 MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da,
                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int IN, int T>
__device__ __forceinline__ void mma(float (&d)[IN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (IN == 256)
    mma_m64n256k16<T, T>(d, da, db);
  else if constexpr (IN == 128)
    mma_m64n128k16<T, T>(d, da, db);
  else if constexpr (IN == 64)
    mma_m64n64k16<T, T>(d, da, db);
  else
    mma_m64n16k16<T, T>(d, da, db);
}

// ------------------------------------------------------------ bf16 path
constexpr int kStages = 4;
constexpr int kStageBytes = 48 * 1024;
constexpr int kThreads = 384;        // two consumer warpgroups, one producer
constexpr int kConsumerWarps = 8;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8 + 256 * 4;

// One product's tile: BM × BN outputs, K steps of BK; MN: both operands
// MN-major (dW = xᵀ·dz), else both K-major (dx = dz·Wᵀ); IN: the N of one
// wgmma.  Each consumer warpgroup owns BM/2 rows.
template <int BM_, int BN_, int BK_, bool MN_, int IN_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, IN = IN_;
  static constexpr bool MN = MN_;
  static constexpr int WM = BM / 2, MI = WM / 64, NI = BN / IN, NR = IN / 2;
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
  // MN-major atoms are 64 values wide (B: BN if narrower)
  static constexpr int B_AW = MN ? (BN < 64 ? BN : 64) : BK;
  static constexpr int A_SW = MN ? 128 : BK * 2, B_SW = B_AW * 2;
  static_assert(A_BYTES + B_BYTES <= kStageBytes, "stage too small");
};
using DxWide = Cfg<128, 256, 64, false, 256>;
using DxHalf = Cfg<128, 128, 64, false, 128>;
using DwWide = Cfg<256, 128, 64, true, 64>;
using DxNarrow = Cfg<128, 256, 16, false, 256>;
using DwNarrow = Cfg<256, 16, 64, true, 16>;

// producer: one stage of item `it` at K step ks
template <class C>
__device__ __forceinline__ void load_stage(const CUtensorMap* ma,
                                           const CUtensorMap* mb, uint8_t* st,
                                           uint64_t* bar, const Item& it,
                                           int ks) {
  mbar_expect_tx(bar, C::A_BYTES + C::B_BYTES);
  const int k = ks * C::BK;
  if (C::MN) {
#pragma unroll
    for (int a = 0; a < C::BM / 64; ++a)
      tma_load(st + a * (128 * C::BK), ma, bar, it.tm * C::BM + a * 64, k);
#pragma unroll
    for (int a = 0; a < C::BN / C::B_AW; ++a)
      tma_load(st + C::A_BYTES + a * (C::B_SW * C::BK), mb, bar,
               it.tn * C::BN + a * C::B_AW, k);
  } else {
    tma_load(st, ma, bar, k, it.tm * C::BM);
    tma_load(st + C::A_BYTES, mb, bar, k, it.tn * C::BN);
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// consumers: one item through the ring, then its stores
template <class C>
__device__ __forceinline__ void consume(const Item& it, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty,
                                        float* cs, int& stage, uint32_t& phase,
                                        const Out<__nv_bfloat16>& o) {
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  float acc[C::MI][C::NI][C::NR];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int r = 0; r < C::NR; ++r) acc[i][j][r] = 0.f;
  // the bias form's column sums of dz, from the dz tiles this product
  // stages (row tile 0 only): thread tid sums column tid % 128 over half
  // the K rows of each stage
  constexpr bool kSums = C::MN && C::BN == 128;
  const bool sums = kSums && o.bias && it.tm == 0;
  float csum = 0.f;
  int prev = -1;
  for (int ks = it.k0; ks < it.k1; ++ks) {
    mbar_wait(&full[stage], phase);
    uint8_t* st = smem + stage * kStageBytes;
    const uint32_t a_base = smem_u32(st), b_base = a_base + C::A_BYTES;
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j) fence_regs(acc[i][j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        const uint64_t da = operand_desc<C::A_SW, C::MN, C::BK>(
            a_base, wg * C::WM + i * 64, kk);
#pragma unroll
        for (int j = 0; j < C::NI; ++j)
          mma<C::IN, C::MN ? 1 : 0>(
              acc[i][j], da,
              operand_desc<C::B_SW, C::MN, C::BK>(b_base, j * C::IN, kk));
      }
    }
    wgmma_commit();
    if (kSums && sums) {
      const int c = tid % 128, cc = c % 64;
      const uint8_t* bt = st + C::A_BYTES + (c / 64) * (128 * C::BK);
#pragma unroll 8
      for (int r = wg * (C::BK / 2); r < (wg + 1) * (C::BK / 2); ++r) {
        const int off = r * 128 + ((((cc >> 3) ^ (r & 7)) << 4) | ((cc & 7) << 1));
        csum += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(bt + off));
      }
    }
    wgmma_wait<1>();   // the previous stage's products are done
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j) fence_regs(acc[i][j]);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j) fence_regs(acc[i][j]);
  if (prev >= 0) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);
  }
  if (kSums && sums) {   // the two halves, in a fixed order
    cs[tid] = csum;
    consumers_sync();
    const int col = it.tn * C::BN + tid;
    if (tid < 128 && col < o.hc)
      o.part[it.z * o.slice + (long long)o.f * o.hc + col] = cs[tid] + cs[tid + 128];
    consumers_sync();
  }
  // stores: the wgmma accumulator layout (row 16·warp + lane/4 (+8),
  // columns 8·q + 2·(lane % 4) + {0, 1})
  const int row0 = it.tm * C::BM + wg * C::WM + warp * 16 + lane / 4;
  const int col0 = it.tn * C::BN + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int q = 0; q < C::IN / 8; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + i * 64 + 8 * h, c = col0 + j * C::IN + 8 * q;
          const float v0 = acc[i][j][4 * q + 2 * h], v1 = acc[i][j][4 * q + 2 * h + 1];
          if (C::MN) {
            if (r < o.f && c < o.hc)
              *reinterpret_cast<float2*>(o.part + it.z * o.slice +
                                         (long long)r * o.hc + c) =
                  make_float2(v0, v1);
          } else if (r < o.n && c < o.f) {
            *reinterpret_cast<__nv_bfloat162*>(o.dx + (long long)r * o.f + c) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
}

template <class DX, class DW>
__global__ void __launch_bounds__(kThreads, 1)
    proj_bwd_bf16_kernel(const __grid_constant__ CUtensorMap dx_a,
                         const __grid_constant__ CUtensorMap dx_b,
                         const __grid_constant__ CUtensorMap dw_a,
                         const __grid_constant__ CUtensorMap dw_b,
                         const Work p, const Out<__nv_bfloat16> o) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned stages
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  float* cs = reinterpret_cast<float*>(empty + kStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      const int* items = p.sched + gridDim.x + 1;
      for (int i = p.sched[blockIdx.x]; i < p.sched[blockIdx.x + 1]; ++i) {
        const Item it = decode(p, items[i]);
        for (int ks = it.k0; ks < it.k1; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1u);
          uint8_t* st = smem + stage * kStageBytes;
          if (it.w)
            load_stage<DW>(&dw_a, &dw_b, st, &full[stage], it, ks);
          else
            load_stage<DX>(&dx_a, &dx_b, st, &full[stage], it, ks);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    int stage = 0;
    uint32_t phase = 0;
    const int* items = p.sched + gridDim.x + 1;
    for (int i = p.sched[blockIdx.x]; i < p.sched[blockIdx.x + 1]; ++i) {
      const Item it = decode(p, items[i]);
      if (it.w)
        consume<DW>(it, smem, full, empty, cs, stage, phase, o);
      else
        consume<DX>(it, smem, full, empty, cs, stage, phase, o);
    }
  }
}

// ---------------------------------------------------- TMA descriptors
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 matrix of `outer` rows × `inner` values (row stride ld values),
// read in boxes of box_outer × box_inner with a sw-byte swizzle; TMA
// zero-fills whatever lies outside it
inline bool make_map(CUtensorMap* m, const void* ptr, long long inner,
                     long long outer, long long ld, int box_inner,
                     int box_outer, int sw) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapSwizzle swz = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class DX, class DW>
cudaError_t run_bf16(const __nv_bfloat16* dz, const __nv_bfloat16* x, int ldx,
                     const __nv_bfloat16* w, const Work& p, int grid,
                     const Out<__nv_bfloat16>& o, cudaStream_t s) {
  CUtensorMap m[4];
  const int n = o.n, f = o.f, hc = o.hc;
  // dx = dz·Wᵀ: dz [n, hc] and W [f, hc], both K-major
  // dW = xᵀ·dz: x [n, f] (row stride ldx) and dz, both MN-major
  if (!make_map(&m[0], dz, hc, n, hc, DX::BK, DX::BM, DX::A_SW) ||
      !make_map(&m[1], w, hc, f, hc, DX::BK, DX::BN, DX::B_SW) ||
      !make_map(&m[2], x, f, n, ldx, 64, DW::BK, DW::A_SW) ||
      !make_map(&m[3], dz, hc, n, hc, DW::B_AW, DW::BK, DW::B_SW))
    return cudaErrorInvalidValue;
  auto kernel = proj_bwd_bf16_kernel<DX, DW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, s>>>(m[0], m[1], m[2], m[3], p, o);
  return cudaGetLastError();
}

// ---------------------------------------------- the q/k/v projection (bf16)
namespace fwd {

constexpr int BM = 128, BN = 256, BK = 64;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
static_assert(A_BYTES + B_BYTES <= kStageBytes, "stage too small");
// three stages of the ring, then the output tile staged for its TMA store
// (four boxes of 128 rows × 64 columns, 128-byte swizzle)
constexpr int kFwdStages = 3;
constexpr int kOutBytes = BM * BN * 2;
constexpr int kFwdSmemBytes = kFwdStages * kStageBytes + kOutBytes + 1024 + 2 * kFwdStages * 8;
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use

// qw in the q tiles' epilogue: C a multiple of 16 dividing the tile, and
// wblk's diagonal blocks (8 bytes a column) staged beside the ring
inline bool qw_in_epilogue(int hc, int c) {
  return c >= 16 && c % 16 == 0 && BN % c == 0 && hc % c == 0
         && kFwdSmemBytes + 8 * hc <= kSmemMax;
}

// the walk (tile_of) and the epilogue's arguments
struct Proj {
  const __nv_bfloat16* bias[3];   // [hc] each, or null: no bias
  int n, f, hc, nw, tpm, tiles;   // nw weights; tpm: column tiles per weight
  __nv_bfloat16* qw;              // [n, H·4], or null: no qw
  const __nv_bfloat16* wblk;      // [hc, H·4] block-diagonal
  int c;                          // a head's columns (divides BN)
};

// qw[row, 4h + d] = Σ_k q[row, hC + k]·wblk[hC + k, 4h + d] for the heads
// of q tile (tm, col0), from its staged rounded values and wblk's diagonal
// blocks staged in shared memory (wdiag[col]: the 4 values of column col's
// head), on the tensor cores: consumer warp w takes rows 16w … 16w + 15,
// and per head its C/16 column chunks in ascending order, each one
// mma.m16n8k16 (A by ldmatrix from the swizzled tile, B the chunk's 16 × 4
// values padded to 8 columns with zeros) into f32, then one rounding.
// That is the order and the instruction of a bf16 tensor-core product
// q·wblk over k16 chunks (wblk's off-diagonal zeros add nothing).
__device__ __forceinline__ void qw_epilogue(const Proj& p, const uint8_t* staged,
                                            const uint2* wdiag, int tm, int col0,
                                            int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int heads4 = 4 * (p.hc / p.c);
  // ldmatrix.x4: lane l gives row l % 8 (+ 8 for l / 8 odd) of the 8 × 8
  // matrix l / 8: (rows 0–7, k 0–7), (8–15, 0–7), (0–7, 8–15), (8–15, 8–15)
  const int r_ld = 16 * warp + lane % 8 + 8 * ((lane / 8) % 2), k_ld = 8 * (lane / 16);
  const int n = lane / 4, kq = 2 * (lane % 4);   // B's column, A/B's k pair
  for (int lh = 0; lh < BN / p.c; ++lh) {
    const int head = col0 / p.c + lh;
    if ((head + 1) * p.c > p.hc) break;   // past the last head: the tile's ragged edge
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = lh * p.c; k0 < (lh + 1) * p.c; k0 += 16) {
      const int cc = k0 + k_ld;
      const uint32_t addr = smem_u32(staged + (cc / 64) * (BM * 128) + r_ld * 128 +
                                     ((((cc % 64) / 8) ^ (r_ld % 8)) << 4));
      uint32_t a0, a1, a2, a3;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3) : "r"(addr));
      // B[k][n] = wblk[col0 + k0 + k, 4·head + n] for n < 4, else 0: a
      // register holds rows kq, kq + 1 (b0) and kq + 8, kq + 9 (b1)
      uint32_t b[2] = {0u, 0u};
      if (n < 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 w0 = wdiag[col0 + k0 + kq + 8 * h];
          const uint2 w1 = wdiag[col0 + k0 + kq + 8 * h + 1];
          const uint32_t e0 = n < 2 ? w0.x : w0.y, e1 = n < 2 ? w1.x : w1.y;
          b[h] = (n % 2 ? e0 >> 16 : e0 & 0xffffu) | (n % 2 ? e1 & 0xffff0000u : e1 << 16);
        }
      }
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[0]), "r"(b[1]));
    }
    // acc: rows 16w + lane/4 (acc 0, 1) and + 8 (acc 2, 3), columns kq, kq +
    // 1: the 4 real columns sit in lanes with kq < 4
    if (kq < 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tm * BM + 16 * warp + lane / 4 + 8 * h;
        if (row < p.n)
          *reinterpret_cast<uint32_t*>(p.qw + (size_t)row * heads4 + 4 * head + kq) =
              __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * h])) |
              (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * h + 1])) << 16;
      }
    }
  }
}

// Tile id → (row tile tm, weight m, first column col0): the ids of a row
// tile are its nw·tpm column tiles, column tile fastest.  With qw the
// weights are rotated by tm, so that a grid that is a multiple of nw·tpm
// (132 blocks, 12 tiles a row) does not give every q tile, and so every
// qw epilogue, to the same third of the blocks: a block's weight then
// steps through all nw.  Without qw the rotation is left out: it cost row
// 11's projection 7 µs (kernels/rowtime.py on the H100), the blocks no
// longer keeping one weight's slice each.
__device__ __forceinline__ void tile_of(const Proj& p, int id, int& tm, int& m,
                                        int& col0) {
  const int per_row = p.nw * p.tpm;
  tm = id / per_row;
  const int j = (id % per_row + (p.qw != nullptr ? tm * p.tpm : 0)) % per_row;
  m = j / p.tpm;
  col0 = (j % p.tpm) * BN;
}

// a 2-D box of shared memory to (c0 inner, c1 outer); TMA drops what lies
// outside the tensor
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    proj_fwd_bf16_kernel(const __grid_constant__ CUtensorMap xa,
                         const __grid_constant__ CUtensorMap w0,
                         const __grid_constant__ CUtensorMap w1,
                         const __grid_constant__ CUtensorMap w2,
                         const __grid_constant__ CUtensorMap o0,
                         const __grid_constant__ CUtensorMap o1,
                         const __grid_constant__ CUtensorMap o2, const Proj p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staged = smem + kFwdStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kOutBytes);
  uint64_t* empty = full + kFwdStages;
  uint2* wdiag = reinterpret_cast<uint2*>(empty + kFwdStages);   // [hc] with qw
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int ksteps = (p.f + BK - 1) / BK;
  int stage = 0;
  uint32_t phase = 0;
  if (threadIdx.x >= 256) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 256) return;
    for (int id = blockIdx.x; id < p.tiles; id += gridDim.x) {
      int tm, m, col0;
      tile_of(p, id, tm, m, col0);
      const CUtensorMap* wm = m == 0 ? &w0 : m == 1 ? &w1 : &w2;
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1u);
        uint8_t* st = smem + stage * kStageBytes;
        mbar_expect_tx(&full[stage], A_BYTES + B_BYTES);
        tma_load(st, &xa, &full[stage], ks * BK, tm * BM);
#pragma unroll
        for (int a = 0; a < BN / 64; ++a)
          tma_load(st + A_BYTES + a * (128 * BK), wm, &full[stage], col0 + a * 64,
                   ks * BK);
        if (++stage == kFwdStages) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32,
            lane = tid % 32;
  if (p.qw != nullptr) {   // read after the first epilogue's consumers_sync
    const int heads4 = 4 * (p.hc / p.c);
    for (int col = tid; col < p.hc; col += 256)
      wdiag[col] = __ldg(reinterpret_cast<const uint2*>(
          p.wblk + (size_t)col * heads4 + 4 * (col / p.c)));
  }
  for (int id = blockIdx.x; id < p.tiles; id += gridDim.x) {
    int tm, m, col0;
    tile_of(p, id, tm, m, col0);
    float acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    int prev = -1;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint32_t a_base = smem_u32(smem + stage * kStageBytes);
      const uint32_t b_base = a_base + A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_m64n256k16<0, 1>(acc, operand_desc<128, false, BK>(a_base, wg * 64, kk),
                             operand_desc<128, true, BK>(b_base, 0, kk));
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done
      fence_regs(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kFwdStages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    // the epilogue: the previous tile's store has read the staging tile;
    // the bias added in f32, one rounding, the values written in the
    // wgmma accumulator layout (row 16·warp + lane/4 (+8), columns 8·q +
    // 2·(lane % 4) + {0, 1}) into the 128-byte swizzled boxes the TMA store
    // reads (conflict-free: a warp's 8 rows fall in 8 different 16-byte
    // chunks), then one thread stores the tile
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    consumers_sync();
    const __nv_bfloat16* bias = p.bias[m];
    const int r0 = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int c = col0 + 8 * q + 2 * (lane % 4);
      const float2 b = bias != nullptr && c < p.hc ? __bfloat1622float2(
                                      *reinterpret_cast<const __nv_bfloat162*>(bias + c))
                                : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        uint8_t* box = staged + (q / 8) * (BM * 128);
        *reinterpret_cast<__nv_bfloat162*>(
            box + r * 128 + (((q % 8) ^ (r % 8)) << 4) + 4 * (lane % 4)) =
            __floats2bfloat162_rn(acc[4 * q + 2 * h] + b.x, acc[4 * q + 2 * h + 1] + b.y);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumers_sync();
    if (tid == 0) {
      const CUtensorMap* om = m == 0 ? &o0 : m == 1 ? &o1 : &o2;
#pragma unroll
      for (int a = 0; a < BN / 64; ++a)
        tma_store(om, staged + a * (BM * 128), col0 + a * 64, tm * BM);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    // qw from the staged q tile while the TMA store reads it; the next
    // tile's epilogue rewrites the staging only after every consumer has
    // passed its consumers_sync
    if (p.qw != nullptr && m == 0) qw_epilogue(p, staged, wdiag, tm, col0, tid);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace fwd

// out = x·[W0 | … | W(nw−1)] (+ [b0 | … ]) in bf16 on persistent blocks,
// one per SM or one per tile if fewer (x [n, f], each W [f, hc], f and hc
// multiples of 8; out [n, nw·hc]; nw 1 or 3; b null: no bias, else each
// b[i] [hc]); qw (null: none) [n, H·4] = q·wblk from the q tiles, q = out's
// first hc columns, heads of c columns (fwd::qw_in_epilogue(hc, c); wblk
// [hc, H·4] and qw 8-byte aligned)
inline cudaError_t run_proj_fwd_bf16(const __nv_bfloat16* x,
                                     const __nv_bfloat16* const* w,
                                     const __nv_bfloat16* const* b, int nw,
                                     __nv_bfloat16* out, int n, int f, int hc,
                                     cudaStream_t s, __nv_bfloat16* qw = nullptr,
                                     const __nv_bfloat16* wblk = nullptr,
                                     int c = 0) {
  if (nw < 1 || nw > 3) return cudaErrorInvalidValue;
  if (qw != nullptr && (!fwd::qw_in_epilogue(hc, c) || wblk == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap m[7];
  // x [n, f] K-major in 128 × 64 boxes; each W [f, hc] MN-major in atoms of
  // 64 columns × 64 K rows; each weight's output columns of out (row stride
  // nw·hc) in boxes of 128 rows × 64 columns; the maps of absent weights
  // repeat the first (never read)
  if (!make_map(&m[0], x, f, n, f, fwd::BK, fwd::BM, 128))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    const int wi = i < nw ? i : 0;
    if (!make_map(&m[1 + i], w[wi], hc, f, hc, 64, fwd::BK, 128) ||
        !make_map(&m[4 + i], out + (size_t)wi * hc, hc, n, (long long)nw * hc, 64,
                  fwd::BM, 128))
      return cudaErrorInvalidValue;
  }
  const int tpm = (hc + fwd::BN - 1) / fwd::BN;
  fwd::Proj p{{nullptr, nullptr, nullptr}, n, f, hc, nw, tpm,
              ((n + fwd::BM - 1) / fwd::BM) * nw * tpm, qw, wblk, c};
  if (b != nullptr)
    for (int i = 0; i < nw; ++i) p.bias[i] = b[i];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int smem = fwd::kFwdSmemBytes + (qw != nullptr ? 8 * hc : 0);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fwd::proj_fwd_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  fwd::proj_fwd_bf16_kernel<<<grid, kThreads, smem, s>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], p);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32 path
namespace f32 {

constexpr int BM = 128, BN = 128, BK = 16, THREADS = 256;
constexpr int KP = BK + 4;    // K-major tile: [128 rows][BK + 4]
constexpr int MP = BM + 4;    // MN-major tile: [BK rows][128 + 4]
constexpr int TILE = BM * KP > BK * MP ? BM * KP : BK * MP;

// one 16-byte copy, zero-filled when off
__device__ __forceinline__ void cp16(float* dst, const float* src, bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

// a K-major operand tile (rows r0… < R, K k0… < kend, row stride ld)
__device__ __forceinline__ void load_km(float* s, const float* g, int ld,
                                        int r0, int R, int k0, int kend) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int e = threadIdx.x + THREADS * q;
    const int row = e / 4, kq = e % 4;
    const int gr = r0 + row, gk = k0 + 4 * kq;
    const bool on = gr < R && gk < kend;
    cp16(s + row * KP + 4 * kq, on ? g + (long long)gr * ld + gk : g, on);
  }
}

// an MN-major operand tile (K rows k0… < kend, MN m0… < R, row stride ld)
__device__ __forceinline__ void load_mn(float* s, const float* g, int ld,
                                        int m0, int R, int k0, int kend) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int e = threadIdx.x + THREADS * q;
    const int kk = e / 32, mq = e % 32;
    const int gk = k0 + kk, gm = m0 + 4 * mq;
    const bool on = gk < kend && gm < R;
    cp16(s + kk * MP + 4 * mq, on ? g + (long long)gk * ld + gm : g, on);
  }
}

struct Args {
  const float* dz;
  const float* x;
  int ldx;
  const float* w;
};

// one item: dx tile (K-major operands, thread rows ty + 16·i, columns
// tx + 16·j) or dW chunk (MN-major, rows 4·ty + {0…3} (+64), columns
// 4·tx + {0…3} (+64))
template <bool MN>
__device__ __forceinline__ void item_f32(const Args& a, const Item& it,
                                         const Out<float>& o, float* sm) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n = o.n, f = o.f, hc = o.hc;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const bool sums = MN && o.bias && it.tm == 0 && tid < BN;
  float csum = 0.f;
  const int m0 = it.tm * BM, n0 = it.tn * BN;
  const int kend = MN ? min(n, it.k1 * BK) : hc;
  auto load = [&](int buf, int ks) {
    float* sa = sm + buf * 2 * TILE;
    float* sb = sa + TILE;
    const int k0 = ks * BK;
    if (MN) {
      load_mn(sa, a.x, a.ldx, m0, f, k0, kend);
      load_mn(sb, a.dz, hc, n0, hc, k0, kend);
    } else {
      load_km(sa, a.dz, hc, m0, n, k0, kend);
      load_km(sb, a.w, hc, n0, f, k0, kend);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  load(0, it.k0);
  int buf = 0;
  for (int ks = it.k0; ks < it.k1; ++ks) {
    if (ks + 1 < it.k1)
      load(buf ^ 1, ks + 1);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const float* sa = sm + buf * 2 * TILE;
    const float* sb = sa + TILE;
    if (MN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(sa + kk * MP + 4 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(sa + kk * MP + 64 + 4 * ty);
        const float4 b0 = *reinterpret_cast<const float4*>(sb + kk * MP + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(sb + kk * MP + 64 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (sums) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) csum += sb[kk * MP + tid];
      }
    } else {
#pragma unroll
      for (int kq = 0; kq < BK / 4; ++kq) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * KP + 4 * kq);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(sb + (tx + 16 * j) * KP + 4 * kq);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float t = fmaf(av[i].x, b.x, acc[i][j]);
            t = fmaf(av[i].y, b.y, t);
            t = fmaf(av[i].z, b.z, t);
            acc[i][j] = fmaf(av[i].w, b.w, t);
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  if (sums && n0 + tid < hc)
    o.part[it.z * o.slice + (long long)f * hc + n0 + tid] = csum;
  if (MN) {
    float* out = o.part + it.z * o.slice;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (r >= f) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + 64 * h + 4 * tx;
        if (c < hc)
          *reinterpret_cast<float4*>(out + (long long)r * hc + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < f) o.dx[(long long)r * f + c] = acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    proj_bwd_f32_kernel(const Args a, const Work p, const Out<float> o) {
  __shared__ __align__(16) float sm[2 * 2 * TILE];
  const int* items = p.sched + gridDim.x + 1;
  for (int i = p.sched[blockIdx.x]; i < p.sched[blockIdx.x + 1]; ++i) {
    const Item it = decode(p, items[i]);
    if (it.w)
      item_f32<true>(a, it, o, sm);
    else
      item_f32<false>(a, it, o, sm);
  }
}

// The forward projection in f32: one 128 × 128 output tile of weight
// m = blockIdx.x / tpm per block; x K-major (rows ty + 16·i), W MN-major
// (columns 4·tx + {0…3} (+64)), K ascending, the bias (if any) added in
// f32; out's row stride nw·hc.
__global__ void __launch_bounds__(THREADS, 2)
    proj_fwd_f32_kernel(const float* __restrict__ x, const float* w0,
                        const float* w1, const float* w2, const float* b0,
                        const float* b1, const float* b2,
                        float* __restrict__ out, int n, int f, int hc, int nw,
                        int tpm) {
  __shared__ __align__(16) float sm[2 * 2 * TILE];
  const int m = blockIdx.x / tpm;
  const float* w = m == 0 ? w0 : m == 1 ? w1 : w2;
  const float* bias = m == 0 ? b0 : m == 1 ? b1 : b2;
  const int n0 = (blockIdx.x % tpm) * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = (f + BK - 1) / BK;
  auto load = [&](int buf, int ks) {
    float* sa = sm + buf * 2 * TILE;
    load_km(sa, x, f, m0, n, ks * BK, f);
    load_mn(sa + TILE, w, hc, n0, hc, ks * BK, f);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  load(0, 0);
  int buf = 0;
  for (int ks = 0; ks < steps; ++ks) {
    if (ks + 1 < steps)
      load(buf ^ 1, ks + 1);
    else
      asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const float* sa = sm + buf * 2 * TILE;
    const float* sb = sa + TILE;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(sa + (ty + 16 * i) * KP + 4 * kq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 4 * kq + e;
        const float4 c0 = *reinterpret_cast<const float4*>(sb + kk * MP + 4 * tx);
        const float4 c1 = *reinterpret_cast<const float4*>(sb + kk * MP + 64 + 4 * tx);
        const float bv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = e == 0 ? av[i].x : e == 1 ? av[i].y : e == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  const long long ld = (long long)nw * hc;
  float* o = out + (long long)m * hc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = n0 + 64 * h + 4 * tx;
      if (c < hc)
        *reinterpret_cast<float4*>(o + r * ld + c) =
            bias != nullptr
                ? make_float4(acc[i][4 * h] + bias[c], acc[i][4 * h + 1] + bias[c + 1],
                              acc[i][4 * h + 2] + bias[c + 2], acc[i][4 * h + 3] + bias[c + 3])
                : make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                              acc[i][4 * h + 3]);
    }
  }
}

// out = x·[W0 | … | W(nw−1)] (+ [b0 | … ]) in f32 (f and hc multiples of
// 4; nw 1 or 3; b null: no bias)
inline cudaError_t run_proj_fwd(const float* x, const float* const* w,
                                const float* const* b, int nw, float* out,
                                int n, int f, int hc, cudaStream_t s) {
  if (nw < 1 || nw > 3) return cudaErrorInvalidValue;
  const float* ws[3] = {w[0], w[0], w[0]};
  const float* bs[3] = {nullptr, nullptr, nullptr};
  for (int i = 0; i < nw; ++i) {
    ws[i] = w[i];
    if (b != nullptr) bs[i] = b[i];
  }
  const int tpm = (hc + BN - 1) / BN;
  proj_fwd_f32_kernel<<<dim3(nw * tpm, (n + BM - 1) / BM), THREADS, 0, s>>>(
      x, ws[0], ws[1], ws[2], bs[0], bs[1], bs[2], out, n, f, hc, nw, tpm);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace sm90
