// MeshGraphNets' edge and node blocks, forward and backward, on bf16
// latents of width 128 (kernels/mgn.py holds the plain versions and the
// equations).
//
// Replaces no TPU kernel: the JAX package has no MeshGraphNets.  It was
// added because one processor step of the model is, per directed edge,
// a gather of two node rows, a 384 → 128 → 128 → 128 MLP and a LayerNorm,
// and composed of library calls that step writes the [E, 384] input and
// every layer's output to device memory.
//
// mgn_edge_fwd_kernel: a persistent launch, one block of 8 warps an SM,
// the three weights (bf16, 160 KB) in padded shared memory for the whole
// launch.  A strip is 16 receiver-sorted edges; each warp walks its own
// strips end to end, with no barrier after the weights load, so the warps
// of an SM overlap one another's gathers, products and stores.  A warp
// gathers v[s], v[r] and e into its 16 rows one after another (cp.async),
// and each part is one K=128 product (mma.m16n8k16, A and B by ldmatrix)
// into the same f32 accumulator: the first layer never leaves registers.
// Each layer's epilogue adds the f32 bias, rounds once to bf16 and, but
// for the last, applies the ReLU, writing the rows back over its input in
// shared memory.  The LayerNorm takes each row's 128 values from the
// accumulator fragments (4 lanes a row: two xor shuffles), two passes
// (mean, then Σ(y − mean)²).  e + e' goes out row by row in 16-byte
// stores.  Then the warp walks its e' rows in edge order, 4 columns a
// lane, summing each receiver's run in f32: a run that starts and ends
// inside the strip is written to agg; a run cut by the strip's first or
// last edge leaves a partial (slot 0: the run that came from the previous
// strip, slot 1: the run that goes on into the next), which
// mgn_edge_fixup_kernel adds up in strip order.  No atomics: the same
// inputs give the same bits.
//
// mgn_edge_bwd_kernel: the same strips with W2ᵀ, W1ᵀ and W0_eᵀ in shared
// memory.  Per warp row, lanes owning 4 columns each: g = g_new +
// g_agg[r], x̂ = (y − mean)·rstd, dy = rstd·(gγ − mean(gγ) − x̂·mean(gγ·x̂))
// rounded to bf16; then dh1 = [h1 > 0]·bf16(dy·W2), dh0 = [h0 > 0]·
// bf16(dh1·W1) and de = bf16(g_new + bf16(dh0·W0_e)), products on
// mma.m16n8k16.  dy, dh1 and dh0 go out for the weight gradients (cuBLAS);
// the column sums Σdh0, Σdh1, Σdy, Σg·x̂, Σg stay in each lane's registers
// over all the warp's strips and go out once a warp.  The receiver sums of
// dh0 run in the strip as the forward's, into f32.  mgn_edge_senders_kernel
// sums dh0 over each node's out-edges (edge ids sorted by sender), one warp
// a node, 4 columns a lane.
//
// mgn_node_fwd_kernel / mgn_node_bwd_kernel: the node block, the same
// bodies (fwd_body, bwd_body) with two parts, v and agg, each its own row
// (no index), out = v + v', no receiver sums, and in the backward two
// cotangents formed: dv = g + dh0·W0_v and dagg = dh0·W0_agg.
//
// What bounds it on an H100 (cell: 994,918 edges): bytes.  Forward: e,
// e_new and the saved h0, h1, y (5 × 255 MB) and the gathers, 0.38 ms at
// 3.35 TB/s, against 0.33 ms of products at 989 TFLOP/s.  This first
// version reads its weights from padded shared memory with ldmatrix (no
// wgmma), and a warp waits for its own gathers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 128;            // latent width
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RW = 16;            // rows a warp
constexpr int LDA = C + 8;        // padded shared row (bf16): conflict-free ldmatrix
constexpr int LDW0 = 3 * C + 8;
constexpr int NCOLS = 5;          // backward column sums: db0, db1, db2, dgamma, dbeta

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[j] (columns 8j … 8j + 7 of the warp's 16 rows) += A · Wᵀ over k 0 …
// 127: A the warp's rows at sa (row stride LDA), W rows n = 0 … 127 at sw
// (row stride ldw) from column kofs.  Fragments: acc[j][0, 1] row lane/4,
// acc[j][2, 3] row lane/4 + 8, columns 8j + 2·(lane % 4) + {0, 1}.
__device__ __forceinline__ void warp_gemm(float (&acc)[16][4], const bf16* sa,
                                          const bf16* sw, int ldw, int kofs, int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, sa + (lane & 15) * LDA + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, sw + (jp * 16 + (lane & 7) + (m >> 1) * 8) * ldw + kofs + k0 + (m & 1) * 8);
      mma16816(acc[2 * jp], a, b);
      mma16816(acc[2 * jp + 1], a, b + 2);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the warp's 16 rows of a [n, C] bf16 tensor (rows row0 …, guarded by n)
// into shared memory, zeros past n; idx[] maps a row to its source row
__device__ __forceinline__ void gather_rows(bf16* sa, const bf16* __restrict__ src,
                                            const int* idx, int row0, int n, int lane) {
#pragma unroll
  for (int i = 0; i < (RW * C / 8) / 32; ++i) {
    const int q = i * 32 + lane;
    const int r = q / (C / 8), ch = q % (C / 8);
    bf16* dst = sa + r * LDA + ch * 8;
    const int row = row0 + r;
    if (row < n) {
      const int srow = idx ? idx[row] : row;
      cp_async16(dst, src + (size_t)srow * C + ch * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_wait_all();
  __syncwarp();
}

// the warp's 16 rows of shared memory out to dst (rows row0 …, guarded)
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const bf16* sa, int row0,
                                           int n, int lane) {
#pragma unroll
  for (int i = 0; i < (RW * C / 8) / 32; ++i) {
    const int q = i * 32 + lane;
    const int r = q / (C / 8), ch = q % (C / 8);
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * C + ch * 8) =
          *reinterpret_cast<const uint4*>(sa + r * LDA + ch * 8);
  }
}

// out = bf16(res + the warp's rows of sa) for rows row0 … (guarded), 16
// bytes a lane
__device__ __forceinline__ void add_rows(bf16* __restrict__ out, const bf16* __restrict__ res,
                                         const bf16* sa, int row0, int n, int lane) {
#pragma unroll
  for (int i = 0; i < (RW * C / 8) / 32; ++i) {
    const int q = i * 32 + lane;
    const int r = q / (C / 8), ch = q % (C / 8);
    const int row = row0 + r;
    if (row < n) {
      const uint4 ev = *reinterpret_cast<const uint4*>(res + (size_t)row * C + ch * 8);
      const uint4 pv = *reinterpret_cast<const uint4*>(sa + r * LDA + ch * 8);
      const __nv_bfloat162* ea = reinterpret_cast<const __nv_bfloat162*>(&ev);
      const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&pv);
      uint4 o4;
      uint32_t* o = reinterpret_cast<uint32_t*>(&o4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 a = __bfloat1622float2(ea[k]), b = __bfloat1622float2(pa[k]);
        o[k] = pack_bf16(a.x + b.x, a.y + b.y);
      }
      *reinterpret_cast<uint4*>(out + (size_t)row * C + ch * 8) = o4;
    }
  }
}

// acc (+ bias), rounded to bf16, optionally through the ReLU, into the
// warp's rows of shared memory
__device__ __forceinline__ void epilogue_to_smem(bf16* sa, const float (&acc)[16][4],
                                                 const float* __restrict__ bias, bool relu,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();   // every lane is done reading sa
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    const float b0 = bias ? __ldg(bias + col) : 0.f, b1 = bias ? __ldg(bias + col + 1) : 0.f;
    float v[4] = {acc[j][0] + b0, acc[j][1] + b1, acc[j][2] + b0, acc[j][3] + b1};
    if (relu)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = fmaxf(v[q], 0.f);
    *reinterpret_cast<uint32_t*>(sa + g * LDA + col) = pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(sa + (g + 8) * LDA + col) = pack_bf16(v[2], v[3]);
  }
  __syncwarp();
}

template <typename TO>
__device__ __forceinline__ void put4(TO* p, const float* v);
template <>
__device__ __forceinline__ void put4<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void put4<bf16>(bf16* p, const float* v) {
  uint2 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename TO>
__device__ __forceinline__ void put(TO* p, float v);
template <>
__device__ __forceinline__ void put<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void put<bf16>(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The receiver runs of the warp's rows (a strip of RW edges), 4 columns a
// lane, in edge order, summed in f32: a run that starts and ends inside the
// strip goes to out[r]; a run cut by the strip's first edge to part slot 0,
// one cut by its last edge (and not its first) to slot 1.  my_r: lane i
// holds the receiver of the strip's row i.
template <typename TO>
__device__ void warp_run_sums(const bf16* sa, int my_r, int prev_r, int next_r, int n_rows,
                              TO* __restrict__ out, float* __restrict__ part, int lane) {
  int cur = __shfl_sync(0xffffffffu, my_r, 0);
  bool open_start = prev_r == cur;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n_rows; ++i) {
    const int r = __shfl_sync(0xffffffffu, my_r, i);
    if (r != cur) {
      if (open_start)
        put4<float>(part + 4 * lane, acc);
      else
        put4<TO>(out + (size_t)cur * C + 4 * lane, acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = 0.f;
      cur = r;
      open_start = false;
    }
    const uint2 u = *reinterpret_cast<const uint2*>(sa + i * LDA + 4 * lane);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    acc[0] += a.x;
    acc[1] += a.y;
    acc[2] += b.x;
    acc[3] += b.y;
  }
  if (next_r == cur)
    put4<float>(part + (open_start ? 0 : C) + 4 * lane, acc);
  else if (open_start)
    put4<float>(part + 4 * lane, acc);
  else
    put4<TO>(out + (size_t)cur * C + 4 * lane, acc);
}

__device__ __forceinline__ void load_weight(bf16* sw, int ldw, const bf16* __restrict__ w,
                                            int k, int tid) {
  const int chunks = k / 8;
  for (int q = tid; q < C * chunks; q += THREADS) {
    const int r = q / chunks, ch = q % chunks;
    *reinterpret_cast<uint4*>(sw + r * ldw + ch * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)r * k + ch * 8);
  }
}

// One MLP_ln block over rows: out = res + LayerNorm(MLP([part 0, …, part
// NP − 1])), the parts' rows gathered through idx (null: the row itself).
struct Fwd {
  const bf16* src[3];
  const int* idx[3];
  const bf16* res;
  int n_rows;
  const bf16* w0;     // [C, NP · C]
  const float* b0;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const float* gamma;
  const float* beta;
  float eps;
  bf16* out;
  const int* receivers;   // SUMS: the rows' receivers (sorted)
  bf16* agg;              // SUMS: Σ over each receiver's rows of LayerNorm(…)
  float* part;            // SUMS: [ceil(n_rows / RW), 2, C]
  bf16* h0;               // saved (all null in eval)
  bf16* h1;
  bf16* y;
  float* mean;
  float* rstd;
};

template <int NP>
constexpr size_t fwd_smem() {
  return (size_t)(C * (NP * C + 8) + 2 * C * LDA + WARPS * RW * LDA) * sizeof(bf16);
}

template <int NP, bool SUMS>
__device__ __forceinline__ void fwd_body(const Fwd& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDW = NP * C + 8;
  bf16* sw0 = reinterpret_cast<bf16*>(smem);
  bf16* sw1 = sw0 + C * LDW;
  bf16* sw2 = sw1 + C * LDA;
  bf16* sa_all = sw2 + C * LDA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  bf16* sa = sa_all + warp * RW * LDA;
  load_weight(sw0, LDW, p.w0, NP * C, tid);
  load_weight(sw1, LDA, p.w1, C, tid);
  load_weight(sw2, LDA, p.w2, C, tid);
  __syncthreads();
  const int n_strips = (p.n_rows + RW - 1) / RW;
  const bool save = p.h0 != nullptr;
  float acc[16][4];
  // each warp walks its own strips: no barrier after the weights
  for (int strip = blockIdx.x * WARPS + warp; strip < n_strips; strip += gridDim.x * WARPS) {
    const int row0 = strip * RW;
    const int n_rows = min(RW, p.n_rows - row0);
    // layer 0: one K=128 product a part into one accumulator
    zero_acc(acc);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      gather_rows(sa, p.src[q], p.idx[q], row0, p.n_rows, lane);
      warp_gemm(acc, sa, sw0, LDW, q * C, lane);
      __syncwarp();
    }
    epilogue_to_smem(sa, acc, p.b0, true, lane);
    if (save) store_rows(p.h0, sa, row0, p.n_rows, lane);
    // layer 1
    zero_acc(acc);
    warp_gemm(acc, sa, sw1, LDA, 0, lane);
    epilogue_to_smem(sa, acc, p.b1, true, lane);
    if (save) store_rows(p.h1, sa, row0, p.n_rows, lane);
    // layer 2: y = h1 · W2ᵀ + b2, rounded (the LayerNorm reads the rounded y)
    zero_acc(acc);
    warp_gemm(acc, sa, sw2, LDA, 0, lane);
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      const float b0 = __ldg(p.b2 + col), b1 = __ldg(p.b2 + col + 1);
      acc[j][0] = bf_round(acc[j][0] + b0);
      acc[j][1] = bf_round(acc[j][1] + b1);
      acc[j][2] = bf_round(acc[j][2] + b0);
      acc[j][3] = bf_round(acc[j][3] + b1);
      s[0] += acc[j][0] + acc[j][1];
      s[1] += acc[j][2] + acc[j][3];
    }
    if (save) {
      epilogue_to_smem(sa, acc, nullptr, false, lane);
      store_rows(p.y, sa, row0, p.n_rows, lane);
    }
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      mean[h] = s[h] / C;
    }
    float ss[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float d;
      d = acc[j][0] - mean[0]; ss[0] += d * d;
      d = acc[j][1] - mean[0]; ss[0] += d * d;
      d = acc[j][2] - mean[1]; ss[1] += d * d;
      d = acc[j][3] - mean[1]; ss[1] += d * d;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
      ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
      rstd[h] = 1.0f / sqrtf(ss[h] / C + p.eps);
    }
    if (save && t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        if (row < p.n_rows) {
          p.mean[row] = mean[h];
          p.rstd[row] = rstd[h];
        }
      }
    }
    // LayerNorm(y) = (y − mean)·rstd·γ + β, rounded, into the warp's rows
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;
      const float g0 = __ldg(p.gamma + col), g1 = __ldg(p.gamma + col + 1);
      const float be0 = __ldg(p.beta + col), be1 = __ldg(p.beta + col + 1);
      acc[j][0] = (acc[j][0] - mean[0]) * rstd[0] * g0 + be0;
      acc[j][1] = (acc[j][1] - mean[0]) * rstd[0] * g1 + be1;
      acc[j][2] = (acc[j][2] - mean[1]) * rstd[1] * g0 + be0;
      acc[j][3] = (acc[j][3] - mean[1]) * rstd[1] * g1 + be1;
    }
    epilogue_to_smem(sa, acc, nullptr, false, lane);
    add_rows(p.out, p.res, sa, row0, p.n_rows, lane);
    if (SUMS) {
      __syncwarp();
      const int my_r = lane < n_rows ? p.receivers[row0 + lane] : -1;
      const int prev_r = row0 > 0 ? p.receivers[row0 - 1] : -1;
      const int next_r = row0 + n_rows < p.n_rows ? p.receivers[row0 + n_rows] : -1;
      warp_run_sums<bf16>(sa, my_r, prev_r, next_r, n_rows, p.agg,
                          p.part + (size_t)strip * 2 * C, lane);
    }
    __syncwarp();
  }
}

// the edge block: parts v[s], v[r], e; out = e + e'; e' summed over receivers
__global__ void __launch_bounds__(THREADS, 1) mgn_edge_fwd_kernel(Fwd p) { fwd_body<3, true>(p); }
// the node block: parts v, agg; out = v + v'
__global__ void __launch_bounds__(THREADS, 1) mgn_node_fwd_kernel(Fwd p) { fwd_body<2, false>(p); }

// A receiver run cut by strip boundaries, added up by the strip it starts
// in: its slot 1, then slot 0 of each following strip it reaches.
template <typename TO>
__global__ void __launch_bounds__(C) mgn_edge_fixup_kernel(const float* __restrict__ part,
                                                           const int* __restrict__ recv,
                                                           int n_edges, TO* __restrict__ out) {
  const int n_tiles = (n_edges + RW - 1) / RW;
  const int col = threadIdx.x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int first = tile * RW, last = min(first + RW, n_edges) - 1;
    const int r = recv[last];
    if (last + 1 >= n_edges || recv[last + 1] != r) continue;   // closed in the strip
    if (recv[first] == r && first > 0 && recv[first - 1] == r) continue;   // not its start
    float acc = part[((size_t)tile * 2 + 1) * C + col];
    for (int u = tile + 1; u < n_tiles; ++u) {
      acc += part[((size_t)u * 2) * C + col];
      const int u_last = min((u + 1) * RW, n_edges) - 1;
      if (!(u_last + 1 < n_edges && recv[u_last + 1] == r)) break;
    }
    put<TO>(out + (size_t)r * C + col, acc);
  }
}

// The block's backward.  g: the cotangent of out (and, SUMS, of agg at the
// row's receiver).  dx[k] = bf16(res_g[k] + bf16(dh0 · W0_k)) for the
// parts whose cotangent the kernel forms (W0_kᵀ at w0t[k]; res_g[k] null:
// no residual), here the edge part (edge block) or v and agg (node block).
struct Bwd {
  const bf16* g_new;
  const bf16* g_agg;      // SUMS
  const int* receivers;   // SUMS
  int n_rows;
  const bf16* y;
  const float* mean;
  const float* rstd;
  const bf16* h0;
  const bf16* h1;
  const bf16* w2t;        // W2ᵀ [in, out]: dX = dY · W as rows n = in, k = out
  const bf16* w1t;
  const bf16* w0t[2];
  const bf16* res_g[2];
  bf16* dx[2];
  const float* gamma;
  bf16* dy;
  bf16* dh1;
  bf16* dh0;
  float* rsum;            // SUMS: Σ dh0 over each receiver's rows
  float* part;
  float* cols;            // [grid · WARPS, NCOLS, C]
};

template <int NOUT>
constexpr size_t bwd_smem() {
  return (size_t)((2 + NOUT) * C * LDA + 2 * WARPS * RW * LDA) * sizeof(bf16);
}

// lane's 4 columns of the warp's 16 rows in sa, summed into acc
__device__ __forceinline__ void col_sums(float* acc, const bf16* sa, int lane) {
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const uint2 u = *reinterpret_cast<const uint2*>(sa + r * LDA + 4 * lane);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    acc[0] += a.x;
    acc[1] += a.y;
    acc[2] += b.x;
    acc[3] += b.y;
  }
}

// acc rounded to bf16, times [h > 0] from the warp's rows of h in sh, into sa
__device__ __forceinline__ void masked_to_smem(bf16* sa, const bf16* sh, const float (&acc)[16][4],
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 hv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sh + (g + 8 * h) * LDA + col));
      const float v0 = hv.x > 0.f ? acc[j][2 * h] : 0.f;
      const float v1 = hv.y > 0.f ? acc[j][2 * h + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(sa + (g + 8 * h) * LDA + col) = pack_bf16(v0, v1);
    }
  }
  __syncwarp();
}

template <int NOUT, bool SUMS>
__device__ __forceinline__ void bwd_body(const Bwd& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sw2 = reinterpret_cast<bf16*>(smem);
  bf16* sw1 = sw2 + C * LDA;
  bf16* sw0 = sw1 + C * LDA;   // NOUT weights, one after another
  bf16* sa_all = sw0 + NOUT * C * LDA;
  bf16* sh_all = sa_all + WARPS * RW * LDA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* sa = sa_all + warp * RW * LDA;
  bf16* sh = sh_all + warp * RW * LDA;
  load_weight(sw2, LDA, p.w2t, C, tid);
  load_weight(sw1, LDA, p.w1t, C, tid);
#pragma unroll
  for (int k = 0; k < NOUT; ++k) load_weight(sw0 + k * C * LDA, LDA, p.w0t[k], C, tid);
  float cs[NCOLS][4];
#pragma unroll
  for (int q = 0; q < NCOLS; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) cs[q][k] = 0.f;
  float gam[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) gam[k] = p.gamma[4 * lane + k];
  __syncthreads();
  const int n_strips = (p.n_rows + RW - 1) / RW;
  float acc[16][4];
  for (int strip = blockIdx.x * WARPS + warp; strip < n_strips; strip += gridDim.x * WARPS) {
    const int row0 = strip * RW;
    const int n_rows = min(RW, p.n_rows - row0);
    const int my_r = SUMS && lane < n_rows ? p.receivers[row0 + lane] : -1;
    // h1 arrives while the LayerNorm backward runs
#pragma unroll
    for (int i = 0; i < (RW * C / 8) / 32; ++i) {
      const int q = i * 32 + lane;
      const int r = q / (C / 8), ch = q % (C / 8);
      if (row0 + r < p.n_rows)
        cp_async16(sh + r * LDA + ch * 8, p.h1 + (size_t)(row0 + r) * C + ch * 8);
      else
        *reinterpret_cast<uint4*>(sh + r * LDA + ch * 8) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // LayerNorm backward, 4 columns a lane, 8 rows at a time: the rows'
    // loads are all in flight before the first row's reductions
    for (int r0 = 0; r0 < RW; r0 += 8) {
      uint2 gu[8], au[8], yu[8];
      float mu[8], rs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = row0 + r0 + i;
        const int rv = __shfl_sync(0xffffffffu, my_r, r0 + i);
        gu[i] = au[i] = yu[i] = make_uint2(0, 0);
        mu[i] = rs[i] = 0.f;
        if (row < p.n_rows) {
          gu[i] = *reinterpret_cast<const uint2*>(p.g_new + (size_t)row * C + 4 * lane);
          yu[i] = *reinterpret_cast<const uint2*>(p.y + (size_t)row * C + 4 * lane);
          if (SUMS) au[i] = *reinterpret_cast<const uint2*>(p.g_agg + (size_t)rv * C + 4 * lane);
          mu[i] = p.mean[row];
          rs[i] = p.rstd[row];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i;
        float dyv[4] = {0.f, 0.f, 0.f, 0.f};
        if (row0 + r < p.n_rows) {
          float gv[4], xh[4], gy[4];
          const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gu[i]);
          const __nv_bfloat162* ap = reinterpret_cast<const __nv_bfloat162*>(&au[i]);
          const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yu[i]);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float2 a = __bfloat1622float2(gp[k]), b = __bfloat1622float2(ap[k]);
            const float2 c = __bfloat1622float2(yp[k]);
            gv[2 * k] = a.x + b.x;
            gv[2 * k + 1] = a.y + b.y;
            xh[2 * k] = (c.x - mu[i]) * rs[i];
            xh[2 * k + 1] = (c.y - mu[i]) * rs[i];
          }
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            gy[k] = gv[k] * gam[k];
            s1 += gy[k];
            s2 += gy[k] * xh[k];
            cs[3][k] += gv[k] * xh[k];
            cs[4][k] += gv[k];
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            s2 += __shfl_xor_sync(0xffffffffu, s2, o);
          }
          s1 /= C;
          s2 /= C;
#pragma unroll
          for (int k = 0; k < 4; ++k) dyv[k] = bf_round(rs[i] * (gy[k] - s1 - xh[k] * s2));
        }
        uint2 o;
        o.x = pack_bf16(dyv[0], dyv[1]);
        o.y = pack_bf16(dyv[2], dyv[3]);
        *reinterpret_cast<uint2*>(sa + r * LDA + 4 * lane) = o;
#pragma unroll
        for (int k = 0; k < 4; ++k) cs[2][k] += dyv[k];
      }
    }
    __syncwarp();
    store_rows(p.dy, sa, row0, p.n_rows, lane);
    // dh1 = [h1 > 0] · dy · W2
    zero_acc(acc);
    warp_gemm(acc, sa, sw2, LDA, 0, lane);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    masked_to_smem(sa, sh, acc, lane);
    col_sums(cs[1], sa, lane);
    store_rows(p.dh1, sa, row0, p.n_rows, lane);
    // dh0 = [h0 > 0] · dh1 · W1
    gather_rows(sh, p.h0, nullptr, row0, p.n_rows, lane);
    zero_acc(acc);
    warp_gemm(acc, sa, sw1, LDA, 0, lane);
    masked_to_smem(sa, sh, acc, lane);
    col_sums(cs[0], sa, lane);
    store_rows(p.dh0, sa, row0, p.n_rows, lane);
    // dx[k] = res_g[k] + bf16(dh0 · W0_k)
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
      zero_acc(acc);
      warp_gemm(acc, sa, sw0 + k * C * LDA, LDA, 0, lane);
      epilogue_to_smem(sh, acc, nullptr, false, lane);
      if (p.res_g[k])
        add_rows(p.dx[k], p.res_g[k], sh, row0, p.n_rows, lane);
      else
        store_rows(p.dx[k], sh, row0, p.n_rows, lane);
    }
    if (SUMS) {
      __syncwarp();
      const int prev_r = row0 > 0 ? p.receivers[row0 - 1] : -1;
      const int next_r = row0 + n_rows < p.n_rows ? p.receivers[row0 + n_rows] : -1;
      warp_run_sums<float>(sa, my_r, prev_r, next_r, n_rows, p.rsum,
                           p.part + (size_t)strip * 2 * C, lane);
    }
    __syncwarp();
  }
  float* out = p.cols + ((size_t)blockIdx.x * WARPS + warp) * NCOLS * C + 4 * lane;
#pragma unroll
  for (int q = 0; q < NCOLS; ++q)
    *reinterpret_cast<float4*>(out + q * C) = make_float4(cs[q][0], cs[q][1], cs[q][2], cs[q][3]);
}

__global__ void __launch_bounds__(THREADS, 1) mgn_edge_bwd_kernel(Bwd p) { bwd_body<1, true>(p); }
__global__ void __launch_bounds__(THREADS, 1) mgn_node_bwd_kernel(Bwd p) { bwd_body<2, false>(p); }

// out[n] = Σ dh0[e] over n's out-edges, in the order of eid[ptr[n] … ptr[n + 1])
__global__ void __launch_bounds__(256) mgn_edge_senders_kernel(const bf16* __restrict__ dh0,
                                                               const int* __restrict__ ptr,
                                                               const int* __restrict__ eid,
                                                               int n_nodes,
                                                               float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int n = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; n < n_nodes; n += warps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = ptr[n]; i < ptr[n + 1]; ++i) {
      const uint2 u = *reinterpret_cast<const uint2*>(dh0 + (size_t)eid[i] * C + 4 * lane);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      acc[0] += a.x;
      acc[1] += a.y;
      acc[2] += b.x;
      acc[3] += b.y;
    }
    *reinterpret_cast<float4*>(out + (size_t)n * C + 4 * lane) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// set once a kernel a process (the first launch runs before any graph capture)
int smem_attr(const void* kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  *done = rc == 0;
  return rc;
}

bool attr_set[4] = {false, false, false, false};

int launch_fwd(const Fwd& p, bool edge, int grid, cudaStream_t s) {
  const void* kernel = edge ? reinterpret_cast<const void*>(mgn_edge_fwd_kernel)
                            : reinterpret_cast<const void*>(mgn_node_fwd_kernel);
  const size_t smem = edge ? fwd_smem<3>() : fwd_smem<2>();
  int rc = smem_attr(kernel, smem, &attr_set[edge ? 0 : 1]);
  if (rc) return rc;
  if (edge)
    mgn_edge_fwd_kernel<<<grid, THREADS, smem, s>>>(p);
  else
    mgn_node_fwd_kernel<<<grid, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

int launch_bwd(const Bwd& p, bool edge, int grid, cudaStream_t s) {
  const void* kernel = edge ? reinterpret_cast<const void*>(mgn_edge_bwd_kernel)
                            : reinterpret_cast<const void*>(mgn_node_bwd_kernel);
  const size_t smem = edge ? bwd_smem<1>() : bwd_smem<2>();
  int rc = smem_attr(kernel, smem, &attr_set[edge ? 2 : 3]);
  if (rc) return rc;
  if (edge)
    mgn_edge_bwd_kernel<<<grid, THREADS, smem, s>>>(p);
  else
    mgn_node_bwd_kernel<<<grid, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every bf16 tensor is [rows, 128] contiguous and 16-byte aligned; the saved
// pointers (h0, h1, y, mean, rstd) are all null (eval) or all set; grid at
// most ceil(rows / 128) blocks.

// The edge block: e_new = e + e', agg [n_nodes, 128] (zeroed by the caller)
// the receiver sums of e'; part [ceil(E / 16), 2, 128] f32.
int mgn_edge_fwd_launch(const void* v, const void* e, const int* senders, const int* receivers,
                        int n_edges, const void* w0, const float* b0, const void* w1,
                        const float* b1, const void* w2, const float* b2, const float* gamma,
                        const float* beta, float eps, void* e_new, void* agg, float* part,
                        void* h0, void* h1, void* y, float* mean, float* rstd, int grid,
                        void* stream) {
  if (n_edges <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* eb = static_cast<const bf16*>(e);
  Fwd p{{vb, vb, eb}, {senders, receivers, nullptr}, eb, n_edges,
        static_cast<const bf16*>(w0), b0, static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), b2, gamma, beta, eps, static_cast<bf16*>(e_new),
        receivers, static_cast<bf16*>(agg), part, static_cast<bf16*>(h0),
        static_cast<bf16*>(h1), static_cast<bf16*>(y), mean, rstd};
  int rc = launch_fwd(p, true, grid, s);
  if (rc) return rc;
  const int n_strips = (n_edges + RW - 1) / RW;
  mgn_edge_fixup_kernel<bf16><<<n_strips < 8192 ? n_strips : 8192, C, 0, s>>>(
      part, receivers, n_edges, static_cast<bf16*>(agg));
  return (int)cudaGetLastError();
}

// The node block: v_new = v + v' over [v, agg].
int mgn_node_fwd_launch(const void* v, const void* agg, int n_nodes, const void* w0,
                        const float* b0, const void* w1, const float* b1, const void* w2,
                        const float* b2, const float* gamma, const float* beta, float eps,
                        void* v_new, void* h0, void* h1, void* y, float* mean, float* rstd,
                        int grid, void* stream) {
  if (n_nodes <= 0) return 0;
  const bf16* vb = static_cast<const bf16*>(v);
  Fwd p{{vb, static_cast<const bf16*>(agg), nullptr}, {nullptr, nullptr, nullptr}, vb, n_nodes,
        static_cast<const bf16*>(w0), b0, static_cast<const bf16*>(w1), b1,
        static_cast<const bf16*>(w2), b2, gamma, beta, eps, static_cast<bf16*>(v_new),
        nullptr, nullptr, nullptr, static_cast<bf16*>(h0), static_cast<bf16*>(h1),
        static_cast<bf16*>(y), mean, rstd};
  return launch_fwd(p, false, grid, static_cast<cudaStream_t>(stream));
}

// The edge block's backward: de = g_new + dh0 · W0_e; rsum [n_nodes, 128] f32
// (zeroed by the caller) the receiver sums of dh0; cols [grid · 8, 5, 128].
int mgn_edge_bwd_launch(const void* g_new, const void* g_agg, const int* receivers,
                        int n_edges, const void* y, const float* mean, const float* rstd,
                        const void* h0, const void* h1, const void* w2t, const void* w1t,
                        const void* w0et, const float* gamma, void* dy, void* dh1, void* dh0,
                        void* de, float* rsum, float* part, float* cols, int grid,
                        void* stream) {
  if (n_edges <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gb = static_cast<const bf16*>(g_new);
  Bwd p{gb, static_cast<const bf16*>(g_agg), receivers, n_edges,
        static_cast<const bf16*>(y), mean, rstd, static_cast<const bf16*>(h0),
        static_cast<const bf16*>(h1), static_cast<const bf16*>(w2t),
        static_cast<const bf16*>(w1t), {static_cast<const bf16*>(w0et), nullptr},
        {gb, nullptr}, {static_cast<bf16*>(de), nullptr}, gamma, static_cast<bf16*>(dy),
        static_cast<bf16*>(dh1), static_cast<bf16*>(dh0), rsum, part, cols};
  int rc = launch_bwd(p, true, grid, s);
  if (rc) return rc;
  const int n_strips = (n_edges + RW - 1) / RW;
  mgn_edge_fixup_kernel<float><<<n_strips < 8192 ? n_strips : 8192, C, 0, s>>>(
      part, receivers, n_edges, rsum);
  return (int)cudaGetLastError();
}

// The node block's backward: dv = g_new + dh0 · W0_v, dagg = dh0 · W0_agg.
int mgn_node_bwd_launch(const void* g_new, int n_nodes, const void* y, const float* mean,
                        const float* rstd, const void* h0, const void* h1, const void* w2t,
                        const void* w1t, const void* w0vt, const void* w0at,
                        const float* gamma, void* dy, void* dh1, void* dh0, void* dv,
                        void* dagg, float* cols, int grid, void* stream) {
  if (n_nodes <= 0) return 0;
  const bf16* gb = static_cast<const bf16*>(g_new);
  Bwd p{gb, nullptr, nullptr, n_nodes, static_cast<const bf16*>(y), mean, rstd,
        static_cast<const bf16*>(h0), static_cast<const bf16*>(h1),
        static_cast<const bf16*>(w2t), static_cast<const bf16*>(w1t),
        {static_cast<const bf16*>(w0vt), static_cast<const bf16*>(w0at)}, {gb, nullptr},
        {static_cast<bf16*>(dv), static_cast<bf16*>(dagg)}, gamma, static_cast<bf16*>(dy),
        static_cast<bf16*>(dh1), static_cast<bf16*>(dh0), nullptr, nullptr, cols};
  return launch_bwd(p, false, grid, static_cast<cudaStream_t>(stream));
}

int mgn_edge_senders_launch(const void* dh0, const int* s_ptr, const int* s_eid, int n_nodes,
                            float* out, void* stream) {
  if (n_nodes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int warps_per_block = 256 / 32;
  int blocks = (n_nodes + warps_per_block - 1) / warps_per_block;
  if (blocks > 65535) blocks = 65535;
  mgn_edge_senders_kernel<<<blocks, 256, 0, s>>>(static_cast<const bf16*>(dh0), s_ptr, s_eid,
                                                 n_nodes, out);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
