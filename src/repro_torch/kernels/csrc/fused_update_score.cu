// fused_update_score / fused_update: one flush epoch of R table rows, in
// place, with the flush's stochastic-rounding uniforms drawn in the
// kernel: the CHUNK-sequential conservative update, then (optionally) the
// scores of each row's candidate keys against its updated table.  Two C
// entry points:
//
//   cml_fused_update_score  row map + score phase; replaces
//       fused_update_score_pallas (src/repro/kernels/sketch.py:422, body
//       _fused_update_score_kernel :389, update body _fused_update_kernel
//       :155) -- the tracked flush;
//   cml_fused_update        identity row map, no score phase; replaces
//       fused_update_pallas (:259; update_pallas :234 is its T = 1 case)
//       -- the untracked all-active flush.
//
// (The row-mapped update whose uniforms are an input,
// fused_update_rows_pallas :344, is fused_update_rows.cu.)
//
// Semantics kept from the reference: CHUNK = 1024 keys is part of the
// result, not a tile size.  Within a chunk every key reads the row minima
// from before the chunk and writes resolve by max; each chunk sees all
// earlier chunks' writes; entries with mult == 0 write nothing.
//
// Bound on the H100: per live key, d random reads and d random stores,
// and the streamed key / mult reads; per candidate, d random reads and
// one estimate write.  What sets the time is the update's chain, not the
// bytes.  Design, in two launches on the caller's stream:
//
//   1. fused_update_draw_kernel: one block of 1024 threads a row, the
//      chain of update_chain.cuh (live slots compacted, columns hashed
//      once, nfold from state tables, a word merge in shared memory with
//      one store a word, empty chunks skipped).  The uniform of the slot
//      at sorted position i of batch row r is element (urows[r], i) of the
//      flush's (total, N) threefry draw (common.cuh cml_uniform), drawn
//      for the live slots only: the reference draws the whole (total, N)
//      grid and gathers `urows`, 4 bytes a slot that this kernel neither
//      reads nor makes anyone write.
//   2. fused_score_kernel (kernel 2 only): read-only, a block of 256
//      threads per (row, tile of SCORE_TILE candidates), so the scores of
//      R rows spread over every SM instead of the R that ran the chains;
//      the table reads go through L1 (__ldg), where a tile's repeated
//      candidates hit.
//
// The row map and the draw's row offsets ride by value in a
// __grid_constant__ struct: CML_SMALL_ROWS rows for small calls,
// CML_ROWMAP_MAX_ROWS a launch above, larger calls split over launches
// (exact: rows are unique, so launches touch disjoint tables).
#include "update_chain.cuh"

namespace {

// The chain's plan (update_chain.cuh): the tracked flush's rows have 64
// chunks and about 5,300-5,450 live slots (serve_counts' Zipf traffic); a
// row of more live slots takes the uncompacted chain.  156,036 bytes,
// under the 196 KB past which L1 shrinks to 28 KB (measured on the H100:
// an 8,192-slot plan of 221,572 bytes took 0.159 ms in kernel 5 against
// 0.148 for this one), and its streamed reads skip L1.
struct FlushPlan {
  static constexpr int kLive = 6144, kChunks = 64, kStates = 2048;
  static constexpr bool kL2Only = true;
};
static_assert(chain_smem_bytes<2, FlushPlan>() == 156036, "the plan's size");
static_assert(chain_smem_bytes<CML_MAX_DEPTH, FlushPlan>() <= 232448,
              "over the block's 227 KB");

constexpr int SCORE_THREADS = 256;
constexpr int SCORE_PER = 4;  // candidates a thread
constexpr int SCORE_TILE = SCORE_THREADS * SCORE_PER;

// A launch's row map and draw rows: block i updates table rows[i] with
// row urows[i] of the flush's uniform grid.
template <int CAP>
struct DrawMap {
  static constexpr int kCap = CAP;
  int32_t rows[CAP];
  int32_t urows[CAP];
};

template <int BITS, int D, typename Map>
__global__ void __launch_bounds__(CHUNK, 1)
fused_update_draw_kernel(uint32_t* __restrict__ tables, int depth, int wpr,
                         const uint32_t* __restrict__ keys,
                         const float* __restrict__ mult, int n,
                         uint32_t k1, uint32_t k2, RowSeeds seeds,
                         uint32_t width, Counter ctr,
                         const __grid_constant__ Map map) {
  extern __shared__ unsigned long long smem[];
  update_chain<BITS, D, FlushPlan>(smem, tables, depth, wpr, keys, mult, n,
                                  seeds, width, ctr, map, UnifDraw{k1, k2});
}

template <int BITS, typename Map>
__global__ void __launch_bounds__(SCORE_THREADS)
fused_score_kernel(const uint32_t* __restrict__ tables, int depth, int wpr,
                   const uint32_t* __restrict__ cand, float* __restrict__ est,
                   int m, RowSeeds seeds, uint32_t width, Counter ctr,
                   const __grid_constant__ Map map) {
  const int r = blockIdx.y;
  const uint32_t* tab =
      tables + (int64_t)map.rows[r] * depth * (int64_t)wpr;
  const int64_t base = (int64_t)r * m;
  const uint32_t wmask = width_mask(width);
  const int j0 = blockIdx.x * SCORE_TILE + (int)threadIdx.x;
  uint32_t key[SCORE_PER], cmin[SCORE_PER];
#pragma unroll
  for (int p = 0; p < SCORE_PER; ++p) {
    const int j = j0 + p * SCORE_THREADS;
    key[p] = j < m ? cand[base + j] : 0u;
    cmin[p] = 0xFFFFFFFFu;
  }
#pragma unroll
  for (int k = 0; k < CML_MAX_DEPTH; ++k) {
    if (k < depth) {
      const uint32_t* trow = tab + (int64_t)k * wpr;
#pragma unroll
      for (int p = 0; p < SCORE_PER; ++p) {
        if (j0 + p * SCORE_THREADS < m) {
          const uint32_t col = col_at(key[p], seeds.s[k], width, wmask);
          const uint32_t v =
              cml_cell<BITS>(__ldg(trow + cml_word_index<BITS>(col)), col);
          cmin[p] = v < cmin[p] ? v : cmin[p];
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < SCORE_PER; ++p) {
    const int j = j0 + p * SCORE_THREADS;
    if (j < m) est[base + j] = cml_decode(cmin[p], ctr);
  }
}

struct Launch {
  uint32_t* tables;
  int depth, wpr;
  const int64_t* rows;   // host (r,)
  const int64_t* urows;  // host (r,)
  int r;
  const uint32_t* keys;
  const float* mult;
  int n;
  uint32_t k1, k2;
  const uint32_t* cand;  // nullptr: no score phase
  float* est;
  int m;
  RowSeeds seeds;
  uint32_t width;
  Counter ctr;
  cudaStream_t stream;
};

template <int BITS, int D, typename Map>
int launch_map(const Launch& a) {
  auto* kern = fused_update_draw_kernel<BITS, D, Map>;
  static bool sized[CML_MAX_DEVICES] = {};
  constexpr int smem = (int)chain_smem_bytes<D, FlushPlan>();
  cudaError_t err = cml_smem_opt_in(kern, smem, sized);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.m + SCORE_TILE - 1) / SCORE_TILE;
  Map map;
  for (int r0 = 0; r0 < a.r; r0 += Map::kCap) {
    const int rr = a.r - r0 < Map::kCap ? a.r - r0 : Map::kCap;
    for (int i = 0; i < rr; ++i) {
      map.rows[i] = (int32_t)a.rows[r0 + i];
      map.urows[i] = (int32_t)a.urows[r0 + i];
    }
    if (a.n > 0) {
      const int64_t off = (int64_t)r0 * a.n;
      kern<<<rr, CHUNK, smem, a.stream>>>(
          a.tables, a.depth, a.wpr, a.keys + off, a.mult + off, a.n, a.k1,
          a.k2, a.seeds, a.width, a.ctr, map);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    if (a.cand != nullptr && tiles > 0) {
      const int64_t off = (int64_t)r0 * a.m;
      fused_score_kernel<BITS, Map>
          <<<dim3(tiles, rr), SCORE_THREADS, 0, a.stream>>>(
              a.tables, a.depth, a.wpr, a.cand + off, a.est + off, a.m,
              a.seeds, a.width, a.ctr, map);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

template <int BITS, int D>
int launch_bits(const Launch& a) {
  if (a.r <= CML_SMALL_ROWS) {
    return launch_map<BITS, D, DrawMap<CML_SMALL_ROWS>>(a);
  }
  return launch_map<BITS, D, DrawMap<CML_ROWMAP_MAX_ROWS>>(a);
}

template <int D>
int launch_depth(int bits, const Launch& a) {
  switch (bits) {
    case 8:
      return launch_bits<8, D>(a);
    case 16:
      return launch_bits<16, D>(a);
    case 32:
      return launch_bits<32, D>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch(const Launch& a, int bits) {
  if (a.r <= 0) return 0;
  if (a.depth < 1 || a.depth > CML_MAX_DEPTH) {
    return (int)cudaErrorInvalidValue;
  }
  if (!chain_words_fit(a.depth, a.wpr)) return (int)cudaErrorInvalidValue;
  return a.depth <= 2 ? launch_depth<2>(bits, a)
                      : launch_depth<CML_MAX_DEPTH>(bits, a);
}

}  // namespace

// rows, urows: host int64 (r,): the table rows (unique and in range) and
// the rows of the flush's (total, n) uniform grid (in [0, total), total <
// 2^31), both checked by the caller and passed on to the kernels by
// value; key: the flush's raw threefry key (k1, k2).
extern "C" int cml_fused_update_score(
    void* tables, int depth, int words_per_row, const int64_t* rows,
    const int64_t* urows, int r, const void* keys, const void* mult, int n,
    uint32_t k1, uint32_t k2, const void* cand, void* est, int m,
    const uint32_t* seeds, uint32_t width, int bits, int log_counter,
    uint32_t max_state, float logb, float bm1, void* stream) {
  const Launch a{(uint32_t*)tables, depth, words_per_row, rows, urows, r,
                 (const uint32_t*)keys, (const float*)mult, n, k1, k2,
                 (const uint32_t*)cand, (float*)est, m,
                 cml_seeds(seeds, depth), width,
                 Counter{log_counter, max_state, logb, bm1},
                 (cudaStream_t)stream};
  return launch(a, bits);
}

// rows: host int64 (t,) 0 .. t-1 (batch row i -> table i); urows as above.
extern "C" int cml_fused_update(
    void* tables, int depth, int words_per_row, const int64_t* rows,
    const int64_t* urows, int t, const void* keys, const void* mult, int n,
    uint32_t k1, uint32_t k2, const uint32_t* seeds, uint32_t width,
    int bits, int log_counter, uint32_t max_state, float logb, float bm1,
    void* stream) {
  const Launch a{(uint32_t*)tables, depth, words_per_row, rows, urows, t,
                 (const uint32_t*)keys, (const float*)mult, n, k1, k2,
                 nullptr, nullptr, 0, cml_seeds(seeds, depth), width,
                 Counter{log_counter, max_state, logb, bm1},
                 (cudaStream_t)stream};
  return launch(a, bits);
}
