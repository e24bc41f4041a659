// The port's dropout stream: a counter-based uint32 hash of (seed, draw
// index, element index), the same function as the JAX package's
// interpret-mode stream (gnn_bfs_rans_tpu/kernels/banded.py::_hash_bits), so
// dropout masks are bit-identical to the JAX package run on the CPU.  The
// Python copy is kernels/dropout.py (the plain versions).  The GAT kernels
// and the epilogue draw once per plane (draw 0);
// the Transformer attention draws once per head (draw h) over each tile's
// [T, Wcols] plane.
//
// An element is kept when hash(seed, flat, draw) >= thresh, with
// thresh = min(floor(rate·2³²), 2³² − 1), and then scaled by 1/(1 − rate).

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t dropout_hash(uint32_t seed, uint32_t flat,
                                                 uint32_t draw = 0u) {
  uint32_t x = (flat ^ (seed * 0x9E3779B9u)) + draw * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// A kernel's dropout arguments: the seed on the device (so a captured graph
// reads the step's seed), the keep threshold and 1/(1 − rate).
struct Drop {
  const int* seed;  // null: no dropout
  uint32_t thresh;
  float inv_keep;
};
