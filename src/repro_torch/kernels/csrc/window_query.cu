// window_query: per key, the weighted reduction over a ring's B buckets of
// the sketch query, in one launch.  One template, three C entry points:
//
//   cml_window_query               one ring (B, d, w), keys (N,), weights
//       (B,); replaces window_query_pallas (src/repro/kernels/sketch.py:618,
//       body _window_query_kernel :125) -- `query` of a windowed tenant;
//   cml_window_query_stacked       R rings (R, B, d, w), keys (R, N),
//       weights (R, B); replaces window_query_stacked_pallas (:686, body
//       _window_query_stacked_kernel :654) -- `query_all` over a window
//       plane;
//   cml_window_query_stacked_rows  rings rows[i] of the native (T, B, d, w)
//       window leaf, read in place; replaces
//       window_query_stacked_rows_pallas (:741, body :723) -- the window
//       tracker refresh and the windowed `topk`.
//
// Semantics kept from the reference (sketch.py:144-153, kernels/ref.py
// window_query_stacked_ref): for b = 0..B-1 in ASCENDING bucket order (not
// from the cursor), est_b = decode(min over the d rows) * weights[r, b];
// mode "sum" starts from est_0 and adds est_1, est_2, ... in that order;
// mode "max" keeps the largest.  Built with -fmad=false (see common.cuh),
// the multiply and the add round separately, as the plain version's
// separate torch ops do, so kernel and plain version are bit-equal.
//
// Bound on the H100: bytes.  Per key, B * d random 4-byte reads from a
// leaf far larger than L2 at full size (32 tenants x 8 buckets x 4 MiB =
// 1 GiB), one coalesced key read and one estimate write.  Design: one
// thread per (ring, key), a 1-D block of 256 threads along one ring's
// keys (grid.y = ring), so key loads and estimate stores coalesce; the
// bucket loop runs inside the thread with the running sum in a register,
// and the random table reads go through the read-only path (__ldg).  All
// offsets are 64-bit: the leaf row stride is B * d * words_per_row.
#include "common.cuh"

namespace {

template <int BITS>
__global__ void __launch_bounds__(256)
window_query_kernel(const uint32_t* __restrict__ tables, int buckets,
                    int depth, int words_per_row,
                    const int32_t* __restrict__ rows,
                    const uint32_t* __restrict__ keys, int n,
                    const float* __restrict__ weights,
                    float* __restrict__ out, int mode_max, RowSeeds seeds,
                    uint32_t width, Counter ctr) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t ring = rows ? rows[r] : r;
  const int64_t bucket_words = (int64_t)depth * words_per_row;
  const uint32_t* base = tables + ring * buckets * bucket_words;
  const uint32_t key = keys[(int64_t)r * n + i];
  uint32_t cols[CML_MAX_DEPTH];
#pragma unroll
  for (int k = 0; k < CML_MAX_DEPTH; ++k) {
    if (k < depth) cols[k] = cml_col(key, seeds.s[k], width);
  }
  float acc = 0.0f;
  for (int b = 0; b < buckets; ++b) {
    const uint32_t* tab = base + b * bucket_words;
    uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < CML_MAX_DEPTH; ++k) {
      if (k < depth) {
        const uint32_t word = __ldg(tab + (int64_t)k * words_per_row +
                                    cml_word_index<BITS>(cols[k]));
        const uint32_t v = cml_cell<BITS>(word, cols[k]);
        cmin = v < cmin ? v : cmin;
      }
    }
    const float est =
        cml_decode(cmin, ctr) * weights[(int64_t)r * buckets + b];
    if (b == 0) {
      acc = est;
    } else if (mode_max) {
      acc = fmaxf(acc, est);
    } else {
      acc = acc + est;
    }
  }
  out[(int64_t)r * n + i] = acc;
}

int launch_window_query(const void* tables, int buckets, int depth,
                        int words_per_row, const void* rows, int r,
                        const void* keys, int n, const void* weights,
                        void* out, int mode_max, const uint32_t* seeds,
                        uint32_t width, int bits, int log_counter,
                        uint32_t max_state, float logb, float bm1,
                        void* stream) {
  if (r <= 0 || n <= 0) return 0;
  if (depth < 1 || depth > CML_MAX_DEPTH || buckets < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1};
  const dim3 block(256);
  const dim3 grid((n + 255) / 256, r);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* tb = (const uint32_t*)tables;
  const int32_t* rw = (const int32_t*)rows;
  const uint32_t* ks = (const uint32_t*)keys;
  const float* wt = (const float*)weights;
  float* o = (float*)out;
  switch (bits) {
    case 8:
      window_query_kernel<8><<<grid, block, 0, s>>>(
          tb, buckets, depth, words_per_row, rw, ks, n, wt, o, mode_max, rs,
          width, ctr);
      break;
    case 16:
      window_query_kernel<16><<<grid, block, 0, s>>>(
          tb, buckets, depth, words_per_row, rw, ks, n, wt, o, mode_max, rs,
          width, ctr);
      break;
    case 32:
      window_query_kernel<32><<<grid, block, 0, s>>>(
          tb, buckets, depth, words_per_row, rw, ks, n, wt, o, mode_max, rs,
          width, ctr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The three entry points share one signature; rows is null for the first
// two (ring i is row i), and r is 1 for the one-ring query.
#define CML_WINDOW_ENTRY(NAME)                                               \
  extern "C" int NAME(const void* tables, int r, int buckets, int depth,     \
                      int words_per_row, const void* rows, const void* keys, \
                      int n, const void* weights, void* out, int mode_max,   \
                      const uint32_t* seeds, uint32_t width, int bits,       \
                      int log_counter, uint32_t max_state, float logb,       \
                      float bm1, void* stream) {                             \
    return launch_window_query(tables, buckets, depth, words_per_row, rows,  \
                               r, keys, n, weights, out, mode_max, seeds,    \
                               width, bits, log_counter, max_state, logb,    \
                               bm1, stream);                                 \
  }

CML_WINDOW_ENTRY(cml_window_query)
CML_WINDOW_ENTRY(cml_window_query_stacked)
CML_WINDOW_ENTRY(cml_window_query_stacked_rows)
