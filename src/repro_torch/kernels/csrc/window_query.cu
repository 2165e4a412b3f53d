// window_query: per key, the weighted reduction over a ring's B buckets of
// the sketch query, in one launch.  Three C entry points:
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
// separate torch ops do, so kernel and plain version are bit-equal.  All
// offsets are 64-bit: the leaf row stride is B * d * words_per_row.
//
// The first two (window_query_kernel): one thread per (ring, key), a 1-D
// block of 256 threads along one ring's keys (grid.y = ring), so key loads
// and estimate stores coalesce; the bucket loop runs inside the thread
// with the running sum in a register, and the random table reads go
// through the read-only path (__ldg).  Their keys are probes, mostly
// distinct, and each costs B * d random reads from a leaf far larger than
// L2 (32 tenants x 8 buckets x 4 MiB = 1 GiB).
//
// The third (window_query_rows_kernel) reads the tracker refresh's
// candidates: the heap joined with the flushed batch as it sits in the
// ring, raw Zipf traffic, so a ring's 16,448 candidates hold about 2,200
// distinct keys.  What bounds it on the H100 is the rate at which the
// card serves random 32-byte reads (about one every 8 cycles of an SM),
// not the repeated candidates, whose reads hit L2.
// tools/window_gather_floor.py measures both (PERF.md): the distinct
// (ring, key, bucket, row) words read once each, one thread a word with
// every SM full, take longer than this kernel on all the candidates, and
// the one-thread-a-key kernel on the distinct keys alone saves under a
// tenth.  Reading each distinct key once costs more than that tenth:
// tools/window_dedup.cu holds two such designs (a hash of the ring's keys
// across a cluster of 8 blocks; a hash per tile of 4,096 candidates), and
// both measured slower, because the barriers between inserting, reducing
// and reading back leave the memory idle.  So this kernel keeps one
// thread per candidate and makes the reads come as fast as the card
// takes them:
//
//   * the bucket loop is unrolled (B and d are template parameters for
//     the windowed path's 8 x 2, with a general instance), so a thread
//     has its candidate's B x d misses in flight together, and reduces
//     them over buckets in ascending order;
//   * 256-thread blocks along one ring's candidates (grid.y = ring), many
//     blocks a ring: every SM keeps misses in flight;
//   * the row map rides by value in the parameter block, as the appends'
//     and fused_update_rows' do (CML_SMALL_ROWS or CML_ROWMAP_MAX_ROWS
//     rings a launch, larger calls split); rows may repeat (a read).
#include "common.cuh"

namespace {

constexpr int QT = 256;  // threads a block

// One key's window estimate over the ring `ring`.  With the geometry a
// template parameter (TB, TD > 0) the bucket loop unrolls, and the
// compiler issues the key's TB x TD loads ahead of the reduction.
template <int BITS, int TB, int TD>
__device__ __forceinline__ float ring_estimate(
    const uint32_t* __restrict__ ring, int buckets, int depth, int wpr,
    uint32_t key, const float* __restrict__ wts, int mode_max,
    const RowSeeds& seeds, uint32_t width, const Counter& ctr) {
  float acc = 0.0f;
  if constexpr (TB > 0 && TD > 0) {
    const int64_t bucket_words = (int64_t)TD * wpr;
    uint32_t col[TD];
    int64_t at[TD];
#pragma unroll
    for (int k = 0; k < TD; ++k) {
      col[k] = cml_col(key, seeds.s[k], width);
      at[k] = (int64_t)k * wpr + cml_word_index<BITS>(col[k]);
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
      for (int k = 0; k < TD; ++k) {
        const uint32_t v =
            cml_cell<BITS>(__ldg(ring + b * bucket_words + at[k]), col[k]);
        cmin = v < cmin ? v : cmin;
      }
      const float est = cml_decode(cmin, ctr) * __ldg(wts + b);
      if (b == 0) {
        acc = est;
      } else if (mode_max) {
        acc = fmaxf(acc, est);
      } else {
        acc = acc + est;
      }
    }
  } else {
    const int64_t bucket_words = (int64_t)depth * wpr;
    uint32_t col[CML_MAX_DEPTH];
#pragma unroll
    for (int k = 0; k < CML_MAX_DEPTH; ++k) {
      if (k < depth) col[k] = cml_col(key, seeds.s[k], width);
    }
    for (int b = 0; b < buckets; ++b) {
      const uint32_t* tab = ring + b * bucket_words;
      uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
      for (int k = 0; k < CML_MAX_DEPTH; ++k) {
        if (k < depth) {
          const uint32_t v = cml_cell<BITS>(
              __ldg(tab + (int64_t)k * wpr + cml_word_index<BITS>(col[k])),
              col[k]);
          cmin = v < cmin ? v : cmin;
        }
      }
      const float est = cml_decode(cmin, ctr) * __ldg(wts + b);
      if (b == 0) {
        acc = est;
      } else if (mode_max) {
        acc = fmaxf(acc, est);
      } else {
        acc = acc + est;
      }
    }
  }
  return acc;
}

template <int BITS>
__global__ void __launch_bounds__(QT)
window_query_kernel(const uint32_t* __restrict__ tables, int buckets,
                    int depth, int words_per_row,
                    const uint32_t* __restrict__ keys, int n,
                    const float* __restrict__ weights,
                    float* __restrict__ out, int mode_max, RowSeeds seeds,
                    uint32_t width, Counter ctr) {
  const int r = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[(int64_t)r * n + i] = ring_estimate<BITS, 0, 0>(
      tables + (int64_t)r * buckets * ((int64_t)depth * words_per_row),
      buckets, depth, words_per_row, keys[(int64_t)r * n + i],
      weights + (int64_t)r * buckets, mode_max, seeds, width, ctr);
}

template <int BITS, int TB, int TD, typename Map>
__global__ void __launch_bounds__(QT)
window_query_rows_kernel(const uint32_t* __restrict__ tables, int buckets,
                         int depth, int wpr,
                         const uint32_t* __restrict__ keys, int n,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int mode_max,
                         RowSeeds seeds, uint32_t width, Counter ctr,
                         const __grid_constant__ Map map) {
  const int r = blockIdx.y;  // the launch's ring index
  const int i = blockIdx.x * QT + threadIdx.x;
  if (i >= n) return;
  const int64_t ring = map.rows[r];
  out[(int64_t)r * n + i] = ring_estimate<BITS, TB, TD>(
      tables + ring * buckets * ((int64_t)depth * wpr), buckets, depth, wpr,
      keys[(int64_t)r * n + i], weights + (int64_t)r * buckets, mode_max,
      seeds, width, ctr);
}

template <int BITS, int TB, int TD, typename Map>
int launch_rows(const uint32_t* tables, int buckets, int depth, int wpr,
                const int64_t* rows, int r, const uint32_t* keys, int n,
                const float* weights, float* out, int mode_max,
                const RowSeeds& seeds, uint32_t width, const Counter& ctr,
                cudaStream_t stream) {
  Map map;
  for (int r0 = 0; r0 < r; r0 += Map::kCap) {
    const int m = r - r0 < Map::kCap ? r - r0 : Map::kCap;
    for (int i = 0; i < m; ++i) map.rows[i] = (int32_t)rows[r0 + i];
    window_query_rows_kernel<BITS, TB, TD, Map>
        <<<dim3((n + QT - 1) / QT, m), QT, 0, stream>>>(
            tables, buckets, depth, wpr, keys + (int64_t)r0 * n, n,
            weights + (int64_t)r0 * buckets, out + (int64_t)r0 * n,
            mode_max, seeds, width, ctr, map);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int BITS, int TB, int TD>
int launch_map(const uint32_t* tables, int buckets, int depth, int wpr,
               const int64_t* rows, int r, const uint32_t* keys, int n,
               const float* weights, float* out, int mode_max,
               const RowSeeds& seeds, uint32_t width, const Counter& ctr,
               cudaStream_t stream) {
  if (r <= CML_SMALL_ROWS) {
    return launch_rows<BITS, TB, TD, RowMap<CML_SMALL_ROWS>>(
        tables, buckets, depth, wpr, rows, r, keys, n, weights, out,
        mode_max, seeds, width, ctr, stream);
  }
  return launch_rows<BITS, TB, TD, RowMap<CML_ROWMAP_MAX_ROWS>>(
      tables, buckets, depth, wpr, rows, r, keys, n, weights, out, mode_max,
      seeds, width, ctr, stream);
}

template <int BITS>
int launch_geometry(const uint32_t* tables, int buckets, int depth, int wpr,
                    const int64_t* rows, int r, const uint32_t* keys, int n,
                    const float* weights, float* out, int mode_max,
                    const RowSeeds& seeds, uint32_t width, const Counter& ctr,
                    cudaStream_t stream) {
  if (buckets == 8 && depth == 2) {  // the windowed path's geometry
    return launch_map<BITS, 8, 2>(tables, buckets, depth, wpr, rows, r, keys,
                                  n, weights, out, mode_max, seeds, width,
                                  ctr, stream);
  }
  return launch_map<BITS, 0, 0>(tables, buckets, depth, wpr, rows, r, keys,
                                n, weights, out, mode_max, seeds, width, ctr,
                                stream);
}

int launch_window_query(const void* tables, int buckets, int depth,
                        int words_per_row, int r, const void* keys, int n,
                        const void* weights, void* out, int mode_max,
                        const uint32_t* seeds, uint32_t width, int bits,
                        int log_counter, uint32_t max_state, float logb,
                        float bm1, void* stream) {
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
  const uint32_t* ks = (const uint32_t*)keys;
  const float* wt = (const float*)weights;
  float* o = (float*)out;
  switch (bits) {
    case 8:
      window_query_kernel<8><<<grid, block, 0, s>>>(
          tb, buckets, depth, words_per_row, ks, n, wt, o, mode_max, rs,
          width, ctr);
      break;
    case 16:
      window_query_kernel<16><<<grid, block, 0, s>>>(
          tb, buckets, depth, words_per_row, ks, n, wt, o, mode_max, rs,
          width, ctr);
      break;
    case 32:
      window_query_kernel<32><<<grid, block, 0, s>>>(
          tb, buckets, depth, words_per_row, ks, n, wt, o, mode_max, rs,
          width, ctr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The first two entry points share one signature; rows is unused (ring i
// is row i), and r is 1 for the one-ring query.
#define CML_WINDOW_ENTRY(NAME)                                               \
  extern "C" int NAME(const void* tables, int r, int buckets, int depth,     \
                      int words_per_row, const void* rows, const void* keys, \
                      int n, const void* weights, void* out, int mode_max,   \
                      const uint32_t* seeds, uint32_t width, int bits,       \
                      int log_counter, uint32_t max_state, float logb,       \
                      float bm1, void* stream) {                             \
    (void)rows;                                                              \
    return launch_window_query(tables, buckets, depth, words_per_row, r,     \
                               keys, n, weights, out, mode_max, seeds,       \
                               width, bits, log_counter, max_state, logb,    \
                               bm1, stream);                                 \
  }

CML_WINDOW_ENTRY(cml_window_query)
CML_WINDOW_ENTRY(cml_window_query_stacked)

// The same signature; rows: host int64 (r,) ring indices into the leaf,
// checked by the caller, passed on to the kernel by value.
extern "C" int cml_window_query_stacked_rows(
    const void* tables, int r, int buckets, int depth, int words_per_row,
    const int64_t* rows, const void* keys, int n, const void* weights,
    void* out, int mode_max, const uint32_t* seeds, uint32_t width, int bits,
    int log_counter, uint32_t max_state, float logb, float bm1,
    void* stream) {
  if (r <= 0 || n <= 0) return 0;
  if (depth < 1 || depth > CML_MAX_DEPTH || buckets < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1};
  auto* tb = (const uint32_t*)tables;
  auto* ks = (const uint32_t*)keys;
  auto* wt = (const float*)weights;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  switch (bits) {
    case 8:
      return launch_geometry<8>(tb, buckets, depth, words_per_row, rows, r,
                                ks, n, wt, o, mode_max, rs, width, ctr, s);
    case 16:
      return launch_geometry<16>(tb, buckets, depth, words_per_row, rows, r,
                                 ks, n, wt, o, mode_max, rs, width, ctr, s);
    case 32:
      return launch_geometry<32>(tb, buckets, depth, words_per_row, rows, r,
                                 ks, n, wt, o, mode_max, rs, width, ctr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
