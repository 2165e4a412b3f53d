// fused_query: multi-tenant sketch query, estimates for (T, N) keys.
//
// Replaces fused_query_pallas (src/repro/kernels/sketch.py:298, body
// _fused_query_kernel :110 and _table_min :87; query_pallas :220 is its
// T = 1 case).
//
// Per key: d seeded fmix32 hashes, d gathers (one 32-bit word each; the
// cell is shifted and masked out of it when cells are narrower than 32
// bits), min over rows, Morris decode (XLA's expm1 times 1 / (b - 1):
// common.cuh cml_decode).
//
// Bound on the H100: bytes.  Each key costs d random 4-byte reads from a
// table far larger than L2 at full size (64 tenants x 4 MiB), plus a
// coalesced 4-byte key read and 4-byte estimate write; the arithmetic is
// a few dozen integer ops and one expm1 polynomial.  Design: one thread per
// (tenant, key), a 1-D block of 256 threads along the keys of one tenant
// (grid.y = tenant), so key loads and estimate stores coalesce, and the
// random table reads go through the read-only path (__ldg).  Nothing is
// staged in shared memory: a 4 MiB table does not fit, and each key
// touches only d words of it.
#include "common.cuh"

namespace {

template <int BITS>
__global__ void __launch_bounds__(256)
fused_query_kernel(const uint32_t* __restrict__ tables, int depth,
                   int words_per_row, const uint32_t* __restrict__ keys,
                   int n, float* __restrict__ out, RowSeeds seeds,
                   uint32_t width, Counter ctr) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* tab =
      tables + (int64_t)t * depth * (int64_t)words_per_row;
  const uint32_t key = keys[(int64_t)t * n + i];
  uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < CML_MAX_DEPTH; ++k) {
    if (k < depth) {
      const uint32_t col = cml_col(key, seeds.s[k], width);
      const uint32_t word =
          __ldg(tab + (int64_t)k * words_per_row + cml_word_index<BITS>(col));
      const uint32_t v = cml_cell<BITS>(word, col);
      cmin = v < cmin ? v : cmin;
    }
  }
  out[(int64_t)t * n + i] = cml_decode(cmin, ctr);
}

}  // namespace

extern "C" int cml_fused_query(const void* tables, int t, int depth,
                               int words_per_row, const void* keys, int n,
                               void* out, const uint32_t* seeds,
                               uint32_t width, int bits, int log_counter,
                               uint32_t max_state, float logb, float bm1,
                               float rlogb, float rbm1, void* stream) {
  if (t <= 0 || n <= 0) return 0;
  if (depth < 1 || depth > CML_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1, rlogb, rbm1};
  const dim3 block(256);
  const dim3 grid((n + 255) / 256, t);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* tb = (const uint32_t*)tables;
  const uint32_t* ks = (const uint32_t*)keys;
  float* o = (float*)out;
  switch (bits) {
    case 8:
      fused_query_kernel<8><<<grid, block, 0, s>>>(tb, depth, words_per_row,
                                                   ks, n, o, rs, width, ctr);
      break;
    case 16:
      fused_query_kernel<16><<<grid, block, 0, s>>>(tb, depth, words_per_row,
                                                    ks, n, o, rs, width, ctr);
      break;
    case 32:
      fused_query_kernel<32><<<grid, block, 0, s>>>(tb, depth, words_per_row,
                                                    ks, n, o, rs, width, ctr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
