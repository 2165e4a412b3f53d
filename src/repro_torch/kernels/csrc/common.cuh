// Shared device code of the sketch kernels: hashing, cell addressing and
// the counter arithmetic.
//
// The counter arithmetic is the reference's jitted graph (xla_f32.cuh,
// repro_torch/core/xla_f32.py `morris_*`): XLA's CPU exp / expm1 / log1p
// polynomials, the float32 reciprocals 1 / (b - 1) and 1 / log b that XLA
// folds divisions into, and FMAs exactly where XLA's LLVM contracts.  The
// build is -fmad=false without fast math, so every other float step is one
// IEEE-rounded float32 operation; a kernel, its plain version on either
// device and the JAX package on the CPU land equal cell states and equal
// estimates, bit for bit.
//
// Cell addressing: a table row is read as 32-bit words.  A `BITS`-wide cell
// at logical column c sits in word c / (32 / BITS) at bit offset
// (c % (32 / BITS)) * BITS.  That one rule covers both storage layouts: a
// packed row of uint32 lanes, and an unpacked uint8 / uint16 row in
// little-endian memory (byte 2c of a uint16 row is word c / 2, bits 16 *
// (c % 2)).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "xla_f32.cuh"

#define CML_MAX_DEPTH 8
// Rows one ring-append launch carries by value (queue_append.cu): 1,024
// rows of (row, fill, count) int32 are 12 KB of the 32,764-byte kernel
// parameter block that sm_90 takes under CUDA 12.1 and later.
#define CML_APPEND_MAX_ROWS 1024
// Rows one row-mapped update (fused_update_rows.cu, and with their
// uniform-grid rows fused_update_score.cu) or ring read (window_query.cu,
// cml_window_query_stacked_rows) launch carries by value: 1,024 int32 row
// indices, 4 KB of the parameter block (8 KB with the grid rows).
#define CML_ROWMAP_MAX_ROWS 1024

struct RowSeeds {
  uint32_t s[CML_MAX_DEPTH];
};

// A launch's row map, by value in the parameter block (a __grid_constant__
// kernel argument): block i serves table or ring rows[i].  Calls of at
// most CML_SMALL_ROWS rows pass the small struct (a launch's host cost
// grows with its parameter block); larger calls pass CML_ROWMAP_MAX_ROWS
// rows a launch and split over launches.
#define CML_SMALL_ROWS 64
template <int CAP>
struct RowMap {
  static constexpr int kCap = CAP;
  int32_t rows[CAP];
};

struct Counter {
  int log;             // 0: linear (CMS) cell, 1: Morris log cell
  uint32_t max_state;  // (1 << bits) - 1
  float logb;          // float32(log b)
  float bm1;           // float32(b - 1)
  float rlogb;         // float32(1) / logb, rounded to float32
  float rbm1;          // float32(1) / bm1, rounded to float32
};

__device__ __forceinline__ uint32_t cml_mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t cml_col(uint32_t key, uint32_t seed,
                                            uint32_t width) {
  return cml_mix32(key ^ seed) % width;
}

template <int BITS>
__device__ __forceinline__ uint32_t cml_cell(uint32_t word, uint32_t col) {
  if constexpr (BITS == 32) {
    return word;
  } else {
    constexpr uint32_t CPW = 32 / BITS;
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    return (word >> ((col % CPW) * BITS)) & MASK;
  }
}

template <int BITS>
__device__ __forceinline__ uint32_t cml_word_index(uint32_t col) {
  return col / (32 / BITS);
}

// expm1(s log b) of a state: decode(s) before its factor 1 / (b - 1).
__device__ __forceinline__ float cml_em(float s, const Counter& c) {
  return xla_f32::expm1(s * c.logb);
}

// exp(-(s log b)) = b^-s: the jitted graph's division by the point mass.
__device__ __forceinline__ float cml_ep(float s, const Counter& c) {
  return xla_f32::exp(-(s * c.logb));
}

__device__ __forceinline__ float cml_decode_f(float s, const Counter& c) {
  if (!c.log) return s;
  return cml_em(s, c) * c.rbm1;
}

__device__ __forceinline__ float cml_decode(uint32_t s, const Counter& c) {
  return cml_decode_f((float)s, c);
}

// A window read's bucket weight as the reference's jitted graph applies it
// to a log cell: (expm1(s log b) * 1 / (b - 1)) * w is reassociated into
// expm1(s log b) * (w * 1 / (b - 1)), the scalar product made once a
// bucket.  Weights and products are flushed as XLA's CPU flushes a
// denormal.
__device__ __forceinline__ float cml_weight_scale(float w, const Counter& c) {
  w = xla_f32::flush(w);
  return c.log ? xla_f32::flush(w * c.rbm1) : w;
}

// decode(s) * w, with ws = cml_weight_scale(w).
__device__ __forceinline__ float cml_decode_scaled(uint32_t s, float ws,
                                                   const Counter& c) {
  const float d = c.log ? cml_em((float)s, c) : (float)s;
  return xla_f32::flush(d * ws);
}

// Largest state whose value does not exceed v (log cells only); `dec(c)`:
// decode of the integral float state c.
template <typename Dec>
__device__ __forceinline__ float cml_encode_floor(float v, const Counter& c,
                                                  Dec dec) {
  const float cs = floorf(xla_f32::log1p(v * c.bm1) * c.rlogb);
  const float limit = __fmaf_rn(fmaxf(v, 1.0f), 0x1.0c6f7ap-20f, v);  // 1e-6
  const float too_high = (dec(cs) > limit) ? 1.0f : 0.0f;
  return fmaxf(cs - too_high, 0.0f);
}

// Add n >= 0 events to a log cell in one step (counters.py `nfold`,
// xla_f32.py `morris_nfold`).  `em(c)` / `ep(c)`: cml_em / cml_ep of the
// integral float state c (a table read or the functions).
template <typename Em, typename Ep>
__device__ __forceinline__ uint32_t cml_nfold_log(uint32_t state, float n,
                                                  float u, const Counter& c,
                                                  Em em, Ep ep) {
  n = xla_f32::flush(n);
  const float s = (float)state;
  const float v2 = __fmaf_rn(em(s), c.rbm1, n);
  const float cs = cml_encode_floor(
      v2, c, [&](float x) { return em(x) * c.rbm1; });
  const float c2 = fmaxf(cs, s);
  const float frac = __fmaf_rn(-em(c2), c.rbm1, v2) * ep(c2);
  const float inc = (u < frac) ? 1.0f : 0.0f;
  float nw = (n > 0.0f) ? c2 + inc : s;
  nw = fminf(fmaxf(nw, 0.0f), (float)c.max_state);
  return (uint32_t)nw;
}

// Add n >= 0 events to a cell in one step (counters.py `nfold`).
__device__ __forceinline__ uint32_t cml_nfold(uint32_t state, float n,
                                              float u, const Counter& c) {
  if (!c.log) {
    float n_int = floorf(n);
    float frac = n - n_int;
    uint32_t bump = (u < frac) ? 1u : 0u;
    uint32_t room = c.max_state - state;
    float add_f = fminf(n_int, 2147483648.0f);
    uint32_t add_u = (uint32_t)add_f + bump;
    return state + (add_u < room ? add_u : room);
  }
  return cml_nfold_log(
      state, n, u, c, [&](float x) { return cml_em(x, c); },
      [&](float x) { return cml_ep(x, c); });
}

// threefry2x32, 20 rounds, of the counter (x1, x2) under the key (k1, k2),
// in place: core/prng.py `threefry2x32`, JAX's threefry_2x32 (rotations
// (13, 15, 26, 6) and (17, 29, 16, 24), parity 0x1BD11BDA).
__device__ __forceinline__ void cml_threefry2x32(uint32_t k1, uint32_t k2,
                                                 uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = __funnelshift_l(x2, x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Element `idx` (a flat row-major index) of `jax.random.uniform` on the raw
// key (k1, k2) under the partitionable threefry scheme (core/prng.py):
// counter (idx >> 32, idx & 0xFFFFFFFF), bits b1 ^ b2, then the float
// step (bits >> 9) | 0x3F800000 as float32, minus 1.
__device__ __forceinline__ float cml_uniform(uint32_t k1, uint32_t k2,
                                             uint64_t idx) {
  uint32_t x1 = (uint32_t)(idx >> 32), x2 = (uint32_t)idx;
  cml_threefry2x32(k1, k2, x1, x2);
  return __uint_as_float(((x1 ^ x2) >> 9) | 0x3F800000u) - 1.0f;
}

// Host side: opt `kern` in to `bytes` of dynamic shared memory on the
// current device, once a device (the attribute is per device); `done`:
// the caller's CML_MAX_DEVICES flags for this kernel.
#define CML_MAX_DEVICES 64
template <typename Kernel>
static inline cudaError_t cml_smem_opt_in(Kernel kern, int bytes,
                                          bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= CML_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Host side: fill the by-value launch structs.
static inline RowSeeds cml_seeds(const uint32_t* seeds, int depth) {
  RowSeeds r{};
  for (int i = 0; i < depth && i < CML_MAX_DEPTH; ++i) r.s[i] = seeds[i];
  return r;
}
