// Device helpers shared by the kernels of this package: float conversions,
// the bf16 rounding point of the TPU kernels' matmul operands, 4-column
// and 8- or 16-byte vector accesses, warp reductions, and the compaction
// of a band mask row to its nonzero columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace band {

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

// A softmax intermediate as the TPU kernels' bf16 matmuls see it
// (gnn_bfs_rans_tpu/kernels/banded.py::_mm_cast): rounded to bf16 when the
// primal dtype is bf16, untouched in f32.
template <typename T> __device__ __forceinline__ float mm_round(float v);
template <> __device__ __forceinline__ float mm_round<float>(float v) { return v; }
template <> __device__ __forceinline__ float mm_round<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// V values of T in one access: 16 bytes (f32 4, bf16 8), or 8 (bf16 4,
// when C is not a multiple of 8)
template <typename T, int V> struct Chunk;
template <> struct Chunk<float, 4> {
  using raw = uint4;
  static __device__ __forceinline__ void unpack(const raw& u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ raw pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <int W> struct BfChunk {   // W 32-bit words of bf16 pairs
  static __device__ __forceinline__ void unpack(const uint32_t* w, float* v) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void pack(const float* v, uint32_t* w) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
};
template <> struct Chunk<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ void unpack(const raw& u, float* v) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    BfChunk<4>::unpack(w, v);
  }
  static __device__ __forceinline__ raw pack(const float* v) {
    uint32_t w[4];
    BfChunk<4>::pack(v, w);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Chunk<__nv_bfloat16, 4> {
  using raw = uint2;
  static __device__ __forceinline__ void unpack(const raw& u, float* v) {
    const uint32_t w[2] = {u.x, u.y};
    BfChunk<2>::unpack(w, v);
  }
  static __device__ __forceinline__ raw pack(const float* v) {
    uint32_t w[2];
    BfChunk<2>::pack(v, w);
    return make_uint2(w[0], w[1]);
  }
};

// A lane's chunks of one block of a head row: chunk g holds columns
// c0 + V·lane + 32·V·g … (+V); zero past C, or when the head is not valid
template <typename T, int V, int NG>
__device__ __forceinline__ void load_row(const T* row, int c0, int C, int lane,
                                         bool valid,
                                         typename Chunk<T, V>::raw (&u)[NG]) {
  using R = typename Chunk<T, V>::raw;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = c0 + V * lane + 32 * V * g;
    u[g] = valid && c < C ? *reinterpret_cast<const R*>(row + c) : R{};
  }
}

// U warp sums at once (the shuffles of independent sums interleave)
template <int U>
__device__ __forceinline__ void warp_sums(float (&v)[U]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] += __shfl_xor_sync(0xffffffffu, v[u], o);
}

// The words of a run of int8 flags, 4 per lane per 128-byte group (g <
// MAXG), zero past `len`: one load per group, all issued together.
template <int MAXG>
__device__ __forceinline__ void load_flags(const int8_t* p, int len, int lane,
                                           uint32_t (&w)[MAXG]) {
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const int i = 128 * g + 4 * lane;
    w[g] = i < len ? *reinterpret_cast<const uint32_t*>(p + i) : 0u;
  }
}

// Appends the indices i < len of the nonzero flags in w (index 128·g +
// 4·lane + b of byte b of w[g]) for which ok(i), in ascending order, to
// out[cnt…] as val(i); returns the new count.  A warp-wide prefix sum
// places each lane's indices: no serial scan over the flags.
template <int MAXG, typename Ok, typename Val>
__device__ __forceinline__ int compact(const uint32_t (&w)[MAXG], int len,
                                       int lane, int* out, int cnt, Ok ok,
                                       Val val) {
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (128 * g >= len) break;   // warp-uniform
    unsigned m = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (((w[g] >> (8 * b)) & 0xffu) != 0u && ok(128 * g + 4 * lane + b))
        m |= 1u << b;
    const int c = __popc(m);
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int pos = cnt + incl - c;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (m & (1u << b)) out[pos++] = val(128 * g + 4 * lane + b);
    cnt += __shfl_sync(0xffffffffu, incl, 31);
  }
  return cnt;
}

// U warp maxima at once
template <int U>
__device__ __forceinline__ void warp_maxs(float (&v)[U]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = fmaxf(v[u], __shfl_xor_sync(0xffffffffu, v[u], o));
}

}  // namespace band
