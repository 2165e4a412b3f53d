// fused_update_rows: the row-mapped flush, in place: batch row i lands
// CHUNK-sequentially in table rows[i]; every other table keeps its cells.
//
// Replaces fused_update_rows_pallas (src/repro/kernels/sketch.py:344,
// body _fused_update_kernel :155): the window flush, whose rows index the
// flat (T*B, d, w) leaf (64-bit offsets), and the untracked flush of a
// fill class.  Its uniforms are an (R, N) float32 input.
//
// The chain is update_chain.cuh's (the design and its semantics are
// described there), shared with the two update kernels of
// fused_update_score.cu, which draw their uniforms instead of reading
// them.  At the window flush's shape, 32 rows x 16,384 sorted keys of
// which about 2,230 a row are live, the bytes bound is under 5 us; the
// chain of 16 rounds a row on one SM sets the time.
//
// What is left (PERF.md): an SM serves about one random 32-byte access
// every 8 cycles, so a row's ~4,500 word reads and ~4,500 word stores
// cost its one SM tens of microseconds wherever they sit in the chain.
// Moving them to other SMs was measured: a cluster of 3-4 blocks a row
// whose other blocks read the cells and store them back, with the chain
// on a shared-memory cache of the row's cells, took longer, its reads of
// distributed shared memory and cluster barriers costing more than the
// device-memory accesses they replaced.
//
// The row map rides by value in a __grid_constant__ struct (the Pallas
// kernel keeps it in SMEM by scalar prefetch): CML_SMALL_ROWS rows for
// small calls, CML_ROWMAP_MAX_ROWS a launch above, larger calls split
// over launches (exact: rows are unique, so launches touch disjoint
// tables).
#include "update_chain.cuh"

namespace {

// The chain's plan (update_chain.cuh): the window flush's rows have 16
// chunks and about 2,230 live slots.  Measured on the H100, L2-only
// streamed reads were slower here (0.0490 ms against 0.0482).
struct RowsPlan {
  static constexpr int kLive = 4096, kChunks = 32, kStates = 4096;
  static constexpr bool kL2Only = false;
};
static_assert(chain_smem_bytes<2, RowsPlan>() == 135428, "the plan's size");

template <int BITS, int D, typename Map>
__global__ void __launch_bounds__(CHUNK, 1)
fused_update_rows_kernel(uint32_t* __restrict__ tables, int depth, int wpr,
                         const uint32_t* __restrict__ keys,
                         const float* __restrict__ mult,
                         const float* __restrict__ unif, int n,
                         RowSeeds seeds, uint32_t width, Counter ctr,
                         const __grid_constant__ Map map) {
  extern __shared__ unsigned long long smem[];
  update_chain<BITS, D, RowsPlan>(smem, tables, depth, wpr, keys, mult, n,
                                 seeds, width, ctr, map, UnifLoad{unif});
}

template <int BITS, int D, typename Map>
int launch_rows(uint32_t* tables, int depth, int wpr, const int64_t* rows,
                int r, const uint32_t* keys, const float* mult,
                const float* unif, int n, const RowSeeds& seeds,
                uint32_t width, const Counter& ctr, cudaStream_t stream) {
  auto* kern = fused_update_rows_kernel<BITS, D, Map>;
  static bool sized[CML_MAX_DEVICES] = {};
  constexpr int smem = (int)chain_smem_bytes<D, RowsPlan>();
  cudaError_t err = cml_smem_opt_in(kern, smem, sized);
  if (err != cudaSuccess) return (int)err;
  Map map;
  for (int r0 = 0; r0 < r; r0 += Map::kCap) {
    const int m = r - r0 < Map::kCap ? r - r0 : Map::kCap;
    for (int i = 0; i < m; ++i) map.rows[i] = (int32_t)rows[r0 + i];
    const int64_t off = (int64_t)r0 * n;
    kern<<<m, CHUNK, smem, stream>>>(
        tables, depth, wpr, keys + off, mult + off, unif + off, n, seeds,
        width, ctr, map);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int BITS, int D>
int launch_bits(uint32_t* tables, int depth, int wpr, const int64_t* rows,
                int r, const uint32_t* keys, const float* mult,
                const float* unif, int n, const RowSeeds& seeds,
                uint32_t width, const Counter& ctr, cudaStream_t stream) {
  if (r <= CML_SMALL_ROWS) {
    return launch_rows<BITS, D, RowMap<CML_SMALL_ROWS>>(
        tables, depth, wpr, rows, r, keys, mult, unif, n, seeds, width, ctr,
        stream);
  }
  return launch_rows<BITS, D, RowMap<CML_ROWMAP_MAX_ROWS>>(
      tables, depth, wpr, rows, r, keys, mult, unif, n, seeds, width, ctr,
      stream);
}

template <int D>
int launch_depth(int bits, uint32_t* tables, int depth, int wpr,
                 const int64_t* rows, int r, const uint32_t* keys,
                 const float* mult, const float* unif, int n,
                 const RowSeeds& seeds, uint32_t width, const Counter& ctr,
                 cudaStream_t stream) {
  switch (bits) {
    case 8:
      return launch_bits<8, D>(tables, depth, wpr, rows, r, keys, mult, unif,
                               n, seeds, width, ctr, stream);
    case 16:
      return launch_bits<16, D>(tables, depth, wpr, rows, r, keys, mult,
                                unif, n, seeds, width, ctr, stream);
    case 32:
      return launch_bits<32, D>(tables, depth, wpr, rows, r, keys, mult,
                                unif, n, seeds, width, ctr, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rows: host int64 (r,) table rows, unique and in range (checked by the
// caller), passed on to the kernel by value.
extern "C" int cml_fused_update_rows(
    void* tables, int depth, int words_per_row, const int64_t* rows, int r,
    const void* keys, const void* mult, const void* unif, int n,
    const uint32_t* seeds, uint32_t width, int bits, int log_counter,
    uint32_t max_state, float logb, float bm1,
    float rlogb, float rbm1, void* stream) {
  if (r <= 0 || n <= 0) return 0;
  if (depth < 1 || depth > CML_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  if (!chain_words_fit(depth, words_per_row)) {
    return (int)cudaErrorInvalidValue;
  }
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1, rlogb, rbm1};
  auto* tb = (uint32_t*)tables;
  auto* ks = (const uint32_t*)keys;
  auto* mu = (const float*)mult;
  auto* un = (const float*)unif;
  auto s = (cudaStream_t)stream;
  if (depth <= 2) {
    return launch_depth<2>(bits, tb, depth, words_per_row, rows, r, ks, mu,
                           un, n, rs, width, ctr, s);
  }
  return launch_depth<CML_MAX_DEPTH>(bits, tb, depth, words_per_row, rows, r,
                                     ks, mu, un, n, rs, width, ctr, s);
}
