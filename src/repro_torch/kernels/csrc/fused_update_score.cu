// fused_update_score / fused_update: one flush epoch of R table rows, in
// place: the CHUNK-sequential conservative update, then (optionally) the
// scores of each row's candidate keys against its updated table.  One
// template, two C entry points:
//
//   cml_fused_update_score  row map + score phase; replaces
//       fused_update_score_pallas (src/repro/kernels/sketch.py:422, body
//       _fused_update_score_kernel :389, update body _fused_update_kernel
//       :155) -- the tracked flush;
//   cml_fused_update        no row map (batch row i -> table i), no score
//       phase; replaces fused_update_pallas (:259; update_pallas :234 is
//       its T = 1 case) -- the untracked all-active flush.
//
// (The row-mapped update without a score phase, fused_update_rows_pallas
// :344, has its own kernel in fused_update_rows.cu.)
//
// Semantics kept from the reference: CHUNK = 1024 keys is part of the
// result, not a tile size.  Within a chunk every key reads the row minima
// from before the chunk and writes resolve by max; each chunk sees all
// earlier chunks' writes; entries with mult == 0 write nothing.
//
// Bound on the H100: bytes, and the chunk barrier.  Per key: d random
// reads, d random read-modify-writes, and the streamed key / mult /
// uniform reads; per candidate: d random reads and one estimate write.
// A tenant table (4 MiB at full size) cannot sit in shared memory
// (227 KB per block), so it stays in device memory.  Design: one block of
// 1024 threads per mapped row, looping over the row's chunks, one key per
// thread:
//   1. read phase: hash, gather the d cells (__ldcg, so the reads see the
//      previous chunk's atomics at L2 and not a stale L1 line), min,
//      nfold with the given uniform; the new state stays in a register;
//   2. __syncthreads();
//   3. write phase: atomicMax on 32-bit cells; for 8- and 16-bit cells
//      (packed lanes and unpacked narrow rows alike) a CAS loop on the
//      aligned containing 32-bit word, comparing only the cell's bits;
//   4. __syncthreads().
// Blocks of different rows never touch the same table (rows are unique),
// so no ordering between blocks is needed.  The parallelism is R blocks:
// a flush of 64 tenants fills 64 of the card's 132 SMs.
#include "common.cuh"

#define CML_CHUNK 1024

namespace {

template <int BITS>
__device__ __forceinline__ void cml_max_cell(uint32_t* row, uint32_t col,
                                             uint32_t val) {
  if constexpr (BITS == 32) {
    atomicMax(row + col, val);
  } else {
    constexpr uint32_t CPW = 32 / BITS;
    constexpr uint32_t MASK = (1u << BITS) - 1u;
    uint32_t* addr = row + col / CPW;
    const uint32_t shift = (col % CPW) * BITS;
    uint32_t old = __ldcg(addr);
    while (((old >> shift) & MASK) < val) {
      const uint32_t nw = (old & ~(MASK << shift)) | (val << shift);
      const uint32_t prev = atomicCAS(addr, old, nw);
      if (prev == old) break;
      old = prev;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(CML_CHUNK)
fused_update_score_kernel(uint32_t* __restrict__ tables, int depth,
                          int words_per_row,
                          const int32_t* __restrict__ rows,
                          const uint32_t* __restrict__ keys,
                          const float* __restrict__ mult,
                          const float* __restrict__ unif, int n,
                          const uint32_t* __restrict__ cand,
                          float* __restrict__ est, int m, RowSeeds seeds,
                          uint32_t width, Counter ctr) {
  const int r = blockIdx.x;
  const int trow = rows ? rows[r] : r;
  uint32_t* tab = tables + (int64_t)trow * depth * (int64_t)words_per_row;
  const int64_t base = (int64_t)r * n;

  for (int lo = 0; lo < n; lo += CML_CHUNK) {
    const int i = lo + (int)threadIdx.x;
    uint32_t cols[CML_MAX_DEPTH];
    uint32_t nv = 0;
    if (i < n) {
      const float mu = mult[base + i];
      if (mu > 0.0f) {
        const uint32_t key = keys[base + i];
        uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
        for (int k = 0; k < CML_MAX_DEPTH; ++k) {
          if (k < depth) {
            cols[k] = cml_col(key, seeds.s[k], width);
            const uint32_t word = __ldcg(tab + (int64_t)k * words_per_row +
                                         cml_word_index<BITS>(cols[k]));
            const uint32_t v = cml_cell<BITS>(word, cols[k]);
            cmin = v < cmin ? v : cmin;
          }
        }
        nv = cml_nfold(cmin, mu, unif[base + i], ctr);
      }
    }
    __syncthreads();
    if (nv > 0) {
#pragma unroll
      for (int k = 0; k < CML_MAX_DEPTH; ++k) {
        if (k < depth) {
          cml_max_cell<BITS>(tab + (int64_t)k * words_per_row, cols[k], nv);
        }
      }
    }
    __syncthreads();
  }

  if (cand == nullptr) return;
  const int64_t cbase = (int64_t)r * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const uint32_t key = cand[cbase + j];
    uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < CML_MAX_DEPTH; ++k) {
      if (k < depth) {
        const uint32_t col = cml_col(key, seeds.s[k], width);
        const uint32_t word = __ldcg(tab + (int64_t)k * words_per_row +
                                     cml_word_index<BITS>(col));
        const uint32_t v = cml_cell<BITS>(word, col);
        cmin = v < cmin ? v : cmin;
      }
    }
    est[cbase + j] = cml_decode(cmin, ctr);
  }
}

}  // namespace

namespace {

int launch_update(void* tables, int depth, int words_per_row,
                  const void* rows, int r, const void* keys,
                  const void* mult, const void* unif, int n,
                  const void* cand, void* est, int m,
                  const uint32_t* seeds, uint32_t width, int bits,
                  int log_counter, uint32_t max_state, float logb, float bm1,
                  void* stream) {
  if (r <= 0) return 0;
  if (depth < 1 || depth > CML_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1};
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* tb = (uint32_t*)tables;
  const int32_t* rw = (const int32_t*)rows;
  const uint32_t* ks = (const uint32_t*)keys;
  const float* mu = (const float*)mult;
  const float* un = (const float*)unif;
  const uint32_t* cd = (const uint32_t*)cand;
  float* es = (float*)est;
  switch (bits) {
    case 8:
      fused_update_score_kernel<8><<<r, CML_CHUNK, 0, s>>>(
          tb, depth, words_per_row, rw, ks, mu, un, n, cd, es, m, rs, width,
          ctr);
      break;
    case 16:
      fused_update_score_kernel<16><<<r, CML_CHUNK, 0, s>>>(
          tb, depth, words_per_row, rw, ks, mu, un, n, cd, es, m, rs, width,
          ctr);
      break;
    case 32:
      fused_update_score_kernel<32><<<r, CML_CHUNK, 0, s>>>(
          tb, depth, words_per_row, rw, ks, mu, un, n, cd, es, m, rs, width,
          ctr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cml_fused_update_score(
    void* tables, int depth, int words_per_row, const void* rows, int r,
    const void* keys, const void* mult, const void* unif, int n,
    const void* cand, void* est, int m, const uint32_t* seeds, uint32_t width,
    int bits, int log_counter, uint32_t max_state, float logb, float bm1,
    void* stream) {
  return launch_update(tables, depth, words_per_row, rows, r, keys, mult,
                       unif, n, cand, est, m, seeds, width, bits, log_counter,
                       max_state, logb, bm1, stream);
}

extern "C" int cml_fused_update(
    void* tables, int depth, int words_per_row, int t, const void* keys,
    const void* mult, const void* unif, int n, const uint32_t* seeds,
    uint32_t width, int bits, int log_counter, uint32_t max_state, float logb,
    float bm1, void* stream) {
  return launch_update(tables, depth, words_per_row, nullptr, t, keys, mult,
                       unif, n, nullptr, nullptr, 0, seeds, width, bits,
                       log_counter, max_state, logb, bm1, stream);
}
