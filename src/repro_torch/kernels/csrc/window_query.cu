// window_query: per key, the weighted reduction over a ring's B buckets of
// the sketch query, in one launch.  Three C entry points:
//
//   cml_window_query               one ring (B, d, w), keys (N,), weights
//       (B,); replaces window_query_pallas (src/repro/kernels/sketch.py:618,
//       body _window_query_kernel :125) -- `query` of a windowed tenant;
//   cml_window_query_stacked       R rings (R, B, d, w), keys (R, N) or
//       one (N,) row shared by every ring (key stride 0), weights (R, B);
//       replaces window_query_stacked_pallas (:686, body
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
// The first two (window_query_kernel) read probes, mostly distinct: each
// costs B * d random 32-byte reads from a leaf far larger than L2 (32
// tenants x 8 buckets x 4 MiB = 1 GiB), and one key's buckets lie 4 MiB
// apart, so no layout of the work reads fewer sectors.  What bounds them
// on the H100 is the rate at which the card serves random reads (about
// 31 G/s with every SM busy, about one every 8 cycles an SM:
// tools/window_gather_floor.py), and for the one-ring query, the latency
// of one round trip.  So every read is put in flight at once, on every SM:
//
//   * one lane a (key, bucket): a group of G lanes (B rounded up to a
//     power of two, at most 32) holds one key, lane j reads bucket j's d
//     cells (all d loads issued together) and computes est_j; the group
//     then gathers its B estimates with warp shuffles and every lane
//     reduces them in ascending bucket order (B > 32: rounds of 32
//     buckets, reduced in order);
//   * the block size falls from 256 to 64 threads until the grid has at
//     least two blocks an SM: the 1,024-probe query runs on 128 blocks,
//     not 4;
//   * with a key stride of 0 (probes shared by every ring), one lane
//     covers its bucket in WQ_RINGS rings: the key is loaded and its d
//     columns hashed once for all of them, and their reads go out
//     together;
//   * B = 8 and d = 2, the windowed path's geometry, is a template
//     instance (loops unrolled); a general instance takes any B and any
//     d <= CML_MAX_DEPTH.
//
// A bucket whose weight is 0 is not read.  Its product is the same bits
// without the read: decode(s) is finite and >= 0 for every state a cell
// can hold (its largest, CMLS16's 65,535, decodes to about 5.2e10), so
// decode(s) * w for w = +0 or -0 is a zero of w's sign, which is exactly
// 0.0f * w; the reduction then runs on the same operands in the same
// order.  That covers `query(n_buckets=k)` (the older buckets), expired
// buckets and an all-expired ring.
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

// ---- kernels 7 and 8: one lane a (key, bucket) ----------------------------

constexpr int WQ_THREADS = 256;  // threads a block at most
constexpr int WQ_MIN_THREADS = 64;
constexpr int WQ_RINGS = 4;      // rings a lane covers when keys are shared

// Lanes a key: B rounded up to a power of two, at most a warp.
__host__ __device__ constexpr int wq_group(int buckets) {
  return buckets > 16 ? 32 : buckets > 8 ? 16 : buckets > 4 ? 8
       : buckets > 2 ? 4 : buckets > 1 ? 2 : 1;
}

__host__ __device__ constexpr int wq_log2(int g) {
  return g >= 32 ? 5 : g >= 16 ? 4 : g >= 8 ? 3 : g >= 4 ? 2 : g >= 2 ? 1
                                                                      : 0;
}

// Rings r0 .. r0 + RT - 1 (those below r), key i: lane j of the key's group
// reads bucket q0 + j of each round.  TB, TD > 0 fix B and d (one round,
// loops unrolled); RT > 1 only with key_stride 0 (one key for every ring).
// Every lane of the warp runs the shuffles: none returns early.
template <int BITS, int TB, int TD, int RT>
__global__ void __launch_bounds__(WQ_THREADS, TD > 0 && RT == 1 ? 8 : 4)
window_query_kernel(const uint32_t* __restrict__ tables, int r, int buckets,
                    int depth, int wpr, const uint32_t* __restrict__ keys,
                    int64_t key_stride, int n,
                    const float* __restrict__ weights,
                    float* __restrict__ out, int mode_max, RowSeeds seeds,
                    uint32_t width, Counter ctr) {
  constexpr int KD = TD > 0 ? TD : CML_MAX_DEPTH;
  const int nb = TB > 0 ? TB : buckets;
  const int g = wq_group(nb);
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = lane >> wq_log2(g);  // the key
  const int j = threadIdx.x & (g - 1);   // its bucket within a round
  const bool valid = i < n;
  const int r0 = blockIdx.y * RT;
  const int64_t bucket_words = (int64_t)(TD > 0 ? TD : depth) * wpr;
  const int64_t ring_words = nb * bucket_words;

  uint32_t col[KD];
  int64_t at[KD];
  {
    const uint32_t key =
        valid ? __ldg(keys + (int64_t)r0 * key_stride + i) : 0u;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      if (TD > 0 || k < depth) {
        col[k] = cml_col(key, seeds.s[k], width);
        at[k] = (int64_t)k * wpr + cml_word_index<BITS>(col[k]);
      }
    }
  }
  float acc[RT] = {};
  for (int q0 = 0; q0 < nb; q0 += g) {
    const int b = q0 + j;
    float est[RT];
#pragma unroll
    for (int x = 0; x < RT; ++x) {
      const int ring = r0 + x;
      const bool live = valid && b < nb && (RT == 1 || ring < r);
      const float w = live ? __ldg(weights + (int64_t)ring * nb + b) : 0.0f;
      est[x] = 0.0f * w;  // weight 0: the product without the read
      if (live && w != 0.0f) {
        const uint32_t* tab = tables + ring * ring_words + b * bucket_words;
        uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
        for (int k = 0; k < KD; ++k) {
          if (TD > 0 || k < depth) {
            const uint32_t v = cml_cell<BITS>(__ldg(tab + at[k]), col[k]);
            cmin = v < cmin ? v : cmin;
          }
        }
        est[x] = cml_decode(cmin, ctr) * w;
      }
    }
    // the round's estimates, in ascending bucket order, on every lane
    const int m = nb - q0 < g ? nb - q0 : g;
#pragma unroll
    for (int x = 0; x < RT; ++x) {
#pragma unroll
      for (int q = 0; q < (TB > 0 ? wq_group(TB) : 32); ++q) {
        if (TB > 0 ? q < TB : q < m) {
          const float v = __shfl_sync(0xFFFFFFFFu, est[x], q, g);
          if (q0 + q == 0) {
            acc[x] = v;
          } else if (mode_max) {
            acc[x] = fmaxf(acc[x], v);
          } else {
            acc[x] = acc[x] + v;
          }
        }
      }
    }
  }
  if (valid && j == 0) {
#pragma unroll
    for (int x = 0; x < RT; ++x) {
      if (RT == 1 || r0 + x < r) out[(int64_t)(r0 + x) * n + i] = acc[x];
    }
  }
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

int wq_sm_count() {
  static int sms[CML_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= CML_MAX_DEVICES) return 0;
  if (!sms[dev]) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev];
}

template <int BITS, int TB, int TD, int RT>
int launch_lanes(const uint32_t* tables, int r, int buckets, int depth,
                 int wpr, const uint32_t* keys, int64_t key_stride, int n,
                 const float* weights, float* out, int mode_max,
                 const RowSeeds& seeds, uint32_t width, const Counter& ctr,
                 cudaStream_t stream) {
  // the largest block that still gives two blocks an SM
  const int64_t lanes = (int64_t)n * wq_group(buckets);
  const int64_t tiles = (r + RT - 1) / RT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  const int64_t want = 2 * (int64_t)wq_sm_count();
  int threads = WQ_THREADS;
  while (threads > WQ_MIN_THREADS &&
         (lanes + threads - 1) / threads * tiles < want) {
    threads /= 2;
  }
  const dim3 grid((unsigned)((lanes + threads - 1) / threads),
                  (unsigned)tiles);
  window_query_kernel<BITS, TB, TD, RT><<<grid, threads, 0, stream>>>(
      tables, r, buckets, depth, wpr, keys, key_stride, n, weights, out,
      mode_max, seeds, width, ctr);
  return (int)cudaGetLastError();
}

template <int BITS, int TB, int TD>
int launch_stride(const uint32_t* tables, int r, int buckets, int depth,
                  int wpr, const uint32_t* keys, int64_t key_stride, int n,
                  const float* weights, float* out, int mode_max,
                  const RowSeeds& seeds, uint32_t width, const Counter& ctr,
                  cudaStream_t stream) {
  if (key_stride == 0 && r > 1) {
    return launch_lanes<BITS, TB, TD, WQ_RINGS>(
        tables, r, buckets, depth, wpr, keys, 0, n, weights, out, mode_max,
        seeds, width, ctr, stream);
  }
  return launch_lanes<BITS, TB, TD, 1>(tables, r, buckets, depth, wpr, keys,
                                       key_stride, n, weights, out, mode_max,
                                       seeds, width, ctr, stream);
}

template <int BITS>
int launch_window_lanes(const uint32_t* tables, int r, int buckets,
                        int depth, int wpr, const uint32_t* keys,
                        int64_t key_stride, int n, const float* weights,
                        float* out, int mode_max, const RowSeeds& seeds,
                        uint32_t width, const Counter& ctr,
                        cudaStream_t stream) {
  if (buckets == 8 && depth == 2) {  // the windowed path's geometry
    return launch_stride<BITS, 8, 2>(tables, r, buckets, depth, wpr, keys,
                                     key_stride, n, weights, out, mode_max,
                                     seeds, width, ctr, stream);
  }
  return launch_stride<BITS, 0, 0>(tables, r, buckets, depth, wpr, keys,
                                   key_stride, n, weights, out, mode_max,
                                   seeds, width, ctr, stream);
}

int launch_window_query(const void* tables, int r, int buckets, int depth,
                        int words_per_row, const void* keys,
                        int64_t key_stride, int n, const void* weights,
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
  auto* tb = (const uint32_t*)tables;
  auto* ks = (const uint32_t*)keys;
  auto* wt = (const float*)weights;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  switch (bits) {
    case 8:
      return launch_window_lanes<8>(tb, r, buckets, depth, words_per_row, ks,
                                    key_stride, n, wt, o, mode_max, rs,
                                    width, ctr, s);
    case 16:
      return launch_window_lanes<16>(tb, r, buckets, depth, words_per_row,
                                     ks, key_stride, n, wt, o, mode_max, rs,
                                     width, ctr, s);
    case 32:
      return launch_window_lanes<32>(tb, r, buckets, depth, words_per_row,
                                     ks, key_stride, n, wt, o, mode_max, rs,
                                     width, ctr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The first two entry points share one signature: keys row i of ring i
// starts at keys + i * key_stride (0: one row shared by every ring); r is
// 1 for the one-ring query.
#define CML_WINDOW_ENTRY(NAME)                                               \
  extern "C" int NAME(const void* tables, int r, int buckets, int depth,     \
                      int words_per_row, const void* keys,                   \
                      int64_t key_stride, int n, const void* weights,        \
                      void* out, int mode_max, const uint32_t* seeds,        \
                      uint32_t width, int bits, int log_counter,             \
                      uint32_t max_state, float logb, float bm1,             \
                      void* stream) {                                        \
    return launch_window_query(tables, r, buckets, depth, words_per_row,     \
                               keys, key_stride, n, weights, out, mode_max,  \
                               seeds, width, bits, log_counter, max_state,   \
                               logb, bm1, stream);                           \
  }

CML_WINDOW_ENTRY(cml_window_query)
CML_WINDOW_ENTRY(cml_window_query_stacked)

// rows: host int64 (r,) ring indices into the leaf, checked by the caller,
// passed on to the kernel by value; keys (r, n).
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
