// fused_update_rows: the row-mapped flush, in place: batch row i lands
// CHUNK-sequentially in table rows[i]; every other table keeps its cells.
//
// Replaces fused_update_rows_pallas (src/repro/kernels/sketch.py:344,
// body _fused_update_kernel :155): the window flush, whose rows index the
// flat (T*B, d, w) leaf (64-bit offsets), and the untracked flush of a
// fill class.
//
// Semantics kept from the reference: CHUNK = 1024 keys is part of the
// result.  Within a chunk every key reads the row minima from before the
// chunk and writes resolve by max; each chunk sees all earlier chunks'
// writes; entries with mult == 0 write nothing.  Built with -fmad=false
// (common.cuh), so cell states equal the plain version's.
//
// What sets its time on the H100 is not bytes (at the window flush's
// shape, 32 rows x 16,384 sorted keys of which about 2,230 a row are
// live, the bound is under 5 us) but the chain of N / CHUNK rounds that
// each row runs in order: a chunk reads what the chunks before it wrote,
// so one block walks a row's chunks one after another.  The first port
// paid per chunk a key / mult / uniform load and a gather from device
// memory, nfold, a barrier, a read plus a compare-and-swap round trip to
// L2 per narrow cell, and a second barrier, on all 32 warps of the block
// though a chunk has about 140 live slots.  Here a chunk's round is a
// gather from L2, nfold, a merge in shared memory and two barriers, on
// the live slots alone:
//
//   1. Before the first chunk, each thread loads its slot of every
//      chunk's mult, sixteen chunks in flight at a time; the live slots
//      are compacted in chunk order into shared memory (their d columns,
//      hashed here once, mult and uniform) by a block-wide prefix sum of
//      per-warp ballots, and their d table words asked of L2
//      (prefetch.global.L2).  The block also tabulates decode(s) and
//      exp(s log b) of the first STATE_TAB states.  Dead slots (every
//      duplicate of a sorted dedup batch, and the ring's stale padding)
//      take no part in a chunk.  A row of more than COMPACT_LIVE live
//      slots, more than MAX_CHUNKS chunks or depth > 2 skips this step,
//      and each chunk's threads take their own slots as they come.
//   2. Chunk by chunk, on the chunk's live slots: gather the d words
//      (__ldcg), nfold (its decode / exp of a state in the tables read
//      from them: the same floats, a lookup for a chain of
//      transcendentals), then merge the new states per 32-bit word in a
//      shared-memory table instead of a compare-and-swap on L2: one
//      64-bit compare-and-swap claims a word and writes (word, value),
//      the value being the word as read with the new state in its lane;
//      another slot of the chunk on the same word merges by per-lane max
//      (__vmaxu2 / __vmaxu4; max for 32-bit cells).  Barrier; the slot
//      that claimed each word stores it once with a plain 32-bit store
//      and frees its table slot; barrier, which orders those stores
//      before the next chunk's __ldcg reads.
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
#include "common.cuh"

namespace {

constexpr int CHUNK = 1024;
constexpr int COMPACT_LIVE = 4096;  // live slots a compacted row holds
constexpr int MAX_CHUNKS = 32;      // chunks a compacted row may have
constexpr unsigned long long FREE = ~0ull;  // a free table slot
constexpr uint32_t OWNER = 1u << 31;        // merge_slot: claimed here
constexpr int STATE_TAB = 4096;  // log-counter states tabulated

// One chunk's written words: at most CHUNK * D, in a table twice that.
template <int D>
__host__ __device__ constexpr int table_slots() {
  return 2 * CHUNK * D;
}

// The merge table, the state tables, and for depth <= 2 the compacted
// live slots with their per-(chunk, warp) counts and scan scratch.
template <int D>
constexpr size_t smem_bytes() {
  return table_slots<D>() * sizeof(unsigned long long) +
         2 * STATE_TAB * sizeof(float) +
         (D <= 2 ? (4 * COMPACT_LIVE + 32 * MAX_CHUNKS + MAX_CHUNKS + 1 + 32) *
                       sizeof(uint32_t)
                 : 0);
}

// The states outside the tables take the functions themselves, behind a
// call the compiler does not evaluate ahead of the branch.
__device__ __noinline__ float decode_slow(float s, Counter c) {
  return cml_decode_f(s, c);
}

__device__ __noinline__ float exp_slow(float s, Counter c) {
  return expf(s * c.logb);
}

// cml_nfold, with decode(s) and exp(s * log b) of states below `ts` read
// from tables the block filled with the same functions (so the same
// floats): a log counter's chain of transcendentals becomes lookups.
__device__ __forceinline__ uint32_t nfold_tab(uint32_t state, float n,
                                              float u, const Counter& c,
                                              const float* dtab,
                                              const float* etab, int ts) {
  if (!c.log) return cml_nfold(state, n, u, c);
  const float s = (float)state;
  const float ds = state < (uint32_t)ts ? dtab[state] : decode_slow(s, c);
  const float v2 = ds + n;
  // cml_encode_floor(v2)
  const float cs = floorf(log1pf(v2 * c.bm1) / c.logb);
  const float slack = 1e-6f * fmaxf(v2, 1.0f);
  const float limit = v2 + slack;
  const float dcs = cs < (float)ts ? dtab[(int)cs] : decode_slow(cs, c);
  const float too_high = (dcs > limit) ? 1.0f : 0.0f;
  const float c2 = fmaxf(fmaxf(cs - too_high, 0.0f), s);
  float dc2, ec2;
  if (c2 < (float)ts) {
    dc2 = dtab[(int)c2];
    ec2 = etab[(int)c2];
  } else {
    dc2 = decode_slow(c2, c);
    ec2 = exp_slow(c2, c);
  }
  const float frac = (v2 - dc2) / ec2;
  const float inc = (u < frac) ? 1.0f : 0.0f;
  float nw = (n > 0.0f) ? c2 + inc : s;
  nw = fminf(fmaxf(nw, 0.0f), (float)c.max_state);
  return (uint32_t)nw;
}

template <int BITS>
__device__ __forceinline__ uint32_t lane_max(uint32_t a, uint32_t b) {
  if constexpr (BITS == 32) {
    return a > b ? a : b;
  } else if constexpr (BITS == 16) {
    return __vmaxu2(a, b);
  } else {
    return __vmaxu4(a, b);
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Logical column of `key` in the row hashed with `seed`: cml_col, with the
// modulo a mask when the width is a power of two (wmask = width - 1, else
// 0).
__device__ __forceinline__ uint32_t col_at(uint32_t key, uint32_t seed,
                                           uint32_t width, uint32_t wmask) {
  const uint32_t h = cml_mix32(key ^ seed);
  return wmask ? (h & wmask) : h % width;
}

// Bit offset of logical column `col`'s cell in its 32-bit word.
template <int BITS>
__device__ __forceinline__ uint32_t cell_shift(uint32_t col) {
  return BITS == 32 ? 0u : (col % (32 / BITS)) * BITS;
}

// Merge `want` (the word as read, with the new state in its lane) into
// word `at`'s slot of a table of `slots` (a power of two): the word's
// first writer claims the slot with one compare-and-swap of (at, want)
// and gets the slot index | OWNER back; a later writer of the same word
// merges by per-lane max.
template <int BITS>
__device__ __forceinline__ uint32_t merge_slot(unsigned long long* table,
                                               uint32_t slots, uint32_t at,
                                               uint32_t want) {
  const unsigned long long mine = ((unsigned long long)at << 32) | want;
  uint32_t h = cml_mix32(at) & (slots - 1);
  unsigned long long cur = atomicCAS(table + h, FREE, mine);
  while (cur != FREE) {
    if ((uint32_t)(cur >> 32) != at) {  // another word: probe on
      h = (h + 1) & (slots - 1);
      cur = atomicCAS(table + h, FREE, mine);
      continue;
    }
    const uint32_t nw = lane_max<BITS>((uint32_t)cur, want);
    if (nw == (uint32_t)cur) return h;
    const unsigned long long prev =
        atomicCAS(table + h, cur, ((unsigned long long)at << 32) | nw);
    if (prev == cur) return h;
    cur = prev;
  }
  return h | OWNER;
}

// Block-wide exclusive prefix sum of v[0 .. m), m <= 2 * CHUNK, in place;
// returns the total.  `sums`: 32 words of scratch.
__device__ __forceinline__ uint32_t scan_exclusive(uint32_t* v, int m,
                                                   uint32_t* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t a = 2 * tid < m ? v[2 * tid] : 0u;
  const uint32_t b = 2 * tid + 1 < m ? v[2 * tid + 1] : 0u;
  uint32_t incl = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += x;
    }
    sums[lane] = w;
  }
  __syncthreads();
  const uint32_t excl = (warp ? sums[warp - 1] : 0u) + incl - a - b;
  if (2 * tid < m) v[2 * tid] = excl;
  if (2 * tid + 1 < m) v[2 * tid + 1] = excl + a;
  const uint32_t total = sums[31];
  __syncthreads();
  return total;
}

// Step 1 of the header note: compact the row's live slots into
// (ccol, cmu, cu) in chunk order, chunk c's at [starts[c], starts[c+1]),
// ccol holding row k's column at [k * COMPACT_LIVE + slot], and ask L2
// for their words.  False, having written nothing, when the row has more
// than COMPACT_LIVE live slots.
template <int BITS>
__device__ __forceinline__ bool compact_live(
    const uint32_t* tab, int depth, int wpr, const uint32_t* __restrict__ kr,
    const float* __restrict__ mr, const float* __restrict__ ur, int n,
    int nch, const RowSeeds& seeds, uint32_t width, uint32_t wmask,
    uint32_t* ccol, float* cmu, float* cu, uint32_t* cnt, uint32_t* starts,
    uint32_t* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // live counts per (chunk, warp), sixteen chunks' mults in flight
  uint64_t mine = 0ull;
  for (int j0 = 0; j0 < nch; j0 += 16) {
    float m16[16];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int i = (j0 + g) * CHUNK + tid;
      m16[g] = j0 + g < nch && i < n ? mr[i] : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const uint32_t ball = __ballot_sync(0xFFFFFFFFu, m16[g] > 0.0f);
      if (j0 + g < nch && lane == 0) cnt[(j0 + g) * 32 + warp] = __popc(ball);
      if (m16[g] > 0.0f) mine |= 1ull << (j0 + g);
    }
  }
  __syncthreads();
  const uint32_t total = scan_exclusive(cnt, nch * 32, sums);
  if (total > (uint32_t)COMPACT_LIVE) return false;  // after scan's barrier
  for (int j0 = 0; j0 < nch; j0 += 8) {
    uint32_t at[8], k8[8];
    float m8[8], u8[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const bool live = (mine >> (j0 + g)) & 1ull;
      const uint32_t ball = __ballot_sync(0xFFFFFFFFu, live);
      at[g] = COMPACT_LIVE;
      if (live) {
        const int i = (j0 + g) * CHUNK + tid;
        at[g] = cnt[(j0 + g) * 32 + warp] +
                __popc(ball & ((1u << lane) - 1u));
        k8[g] = kr[i];
        m8[g] = mr[i];
        u8[g] = ur[i];
      }
    }
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      if (at[g] < (uint32_t)COMPACT_LIVE) {
        cmu[at[g]] = m8[g];
        cu[at[g]] = u8[g];
        for (int k = 0; k < depth; ++k) {
          const uint32_t col = col_at(k8[g], seeds.s[k], width, wmask);
          ccol[k * COMPACT_LIVE + at[g]] = col;
          prefetch_l2(tab + (int64_t)k * wpr + cml_word_index<BITS>(col));
        }
      }
    }
  }
  if (tid < nch) starts[tid] = cnt[tid * 32];
  if (tid == 0) starts[nch] = total;
  __syncthreads();
  return true;
}

// D: the largest depth this instance serves (the loops run k < depth).
template <int BITS, int D, typename Map>
__global__ void __launch_bounds__(CHUNK, 1)
fused_update_rows_kernel(uint32_t* __restrict__ tables, int depth, int wpr,
                         const uint32_t* __restrict__ keys,
                         const float* __restrict__ mult,
                         const float* __restrict__ unif, int n,
                         RowSeeds seeds, uint32_t width, Counter ctr,
                         const __grid_constant__ Map map) {
  extern __shared__ unsigned long long smem[];
  constexpr uint32_t SLOTS = table_slots<D>();
  unsigned long long* table = smem;  // (word << 32 | value), FREE
  float* dtab = (float*)(smem + SLOTS);  // decode(s), s < STATE_TAB
  float* etab = dtab + STATE_TAB;        // exp(s * log b)
  uint32_t* ccol = (uint32_t*)(etab + STATE_TAB);  // compacted live slots
  float* cmu = (float*)(ccol + 2 * COMPACT_LIVE);
  float* cu = cmu + COMPACT_LIVE;
  uint32_t* cnt = (uint32_t*)(cu + COMPACT_LIVE);  // per (chunk, warp)
  uint32_t* starts = cnt + 32 * MAX_CHUNKS;        // first slot a chunk
  uint32_t* sums = starts + MAX_CHUNKS + 1;        // scan scratch
  const int tid = threadIdx.x;
  const uint32_t wmask = (width & (width - 1u)) == 0u ? width - 1u : 0u;
  uint32_t* tab =
      tables + (int64_t)map.rows[blockIdx.x] * depth * (int64_t)wpr;
  const int64_t base = (int64_t)blockIdx.x * n;
  const uint32_t* kr = keys + base;
  const float* mr = mult + base;
  const float* ur = unif + base;
  for (uint32_t s = tid; s < SLOTS; s += CHUNK) table[s] = FREE;
  const int ts = ctr.log ? min((int)ctr.max_state + 1, STATE_TAB) : 0;
  for (int s = tid; s < ts; s += CHUNK) {
    dtab[s] = cml_decode_f((float)s, ctr);
    etab[s] = expf((float)s * ctr.logb);
  }
  const int nch = (n + CHUNK - 1) / CHUNK;
  bool compacted = false;
  if constexpr (D <= 2) {
    if (depth <= 2 && nch <= MAX_CHUNKS) {
      compacted = compact_live<BITS>(tab, depth, wpr, kr, mr, ur, n, nch,
                                     seeds, width, wmask, ccol, cmu, cu, cnt,
                                     starts, sums);
    }
  }
  __syncthreads();

  for (int c = 0; c < nch; ++c) {
    // this thread's slot of chunk c: a compacted live slot, its columns
    // hashed before the loop, or its own slot
    float mu = 0.0f, u = 0.0f;
    uint32_t col[D], word[D], own[D];
    if (compacted) {
      const uint32_t e = starts[c] + tid;
      if (e < starts[c + 1]) {
        mu = cmu[e];
        u = cu[e];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k < depth) col[k] = ccol[k * COMPACT_LIVE + e];
        }
      }
    } else {
      const int i = c * CHUNK + tid;
      if (i < n) {
        mu = mr[i];
        if (mu > 0.0f) {
          const uint32_t key = kr[i];
          u = ur[i];
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (k < depth) col[k] = col_at(key, seeds.s[k], width, wmask);
          }
        }
      }
    }
    uint32_t nv = 0u;
#pragma unroll
    for (int k = 0; k < D; ++k) own[k] = 0u;
    if (mu > 0.0f) {
      uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < depth) {
          word[k] = __ldcg(tab + (int64_t)k * wpr +
                           cml_word_index<BITS>(col[k]));
          const uint32_t v = cml_cell<BITS>(word[k], col[k]);
          cmin = v < cmin ? v : cmin;
        }
      }
      nv = nfold_tab(cmin, mu, u, ctr, dtab, etab, ts);
    }
    // merge: no device-memory write yet, so no barrier before it
    if (nv > 0u) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < depth) {
          const uint32_t want =
              lane_max<BITS>(word[k], nv << cell_shift<BITS>(col[k]));
          if (want != word[k]) {
            const uint32_t s = merge_slot<BITS>(
                table, SLOTS,
                (uint32_t)k * (uint32_t)wpr + cml_word_index<BITS>(col[k]),
                want);
            if (s & OWNER) own[k] = (s & ~OWNER) + 1u;
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (own[k]) {
        const unsigned long long v = table[own[k] - 1u];
        __stcg(tab + (uint32_t)(v >> 32), (uint32_t)v);
        table[own[k] - 1u] = FREE;
      }
    }
    __syncthreads();
  }
}

template <int BITS, int D, typename Map>
int launch_rows(uint32_t* tables, int depth, int wpr, const int64_t* rows,
                int r, const uint32_t* keys, const float* mult,
                const float* unif, int n, const RowSeeds& seeds,
                uint32_t width, const Counter& ctr, cudaStream_t stream) {
  auto* kern = fused_update_rows_kernel<BITS, D, Map>;
  static bool sized[CML_MAX_DEVICES] = {};
  cudaError_t err = cml_smem_opt_in(kern, (int)smem_bytes<D>(), sized);
  if (err != cudaSuccess) return (int)err;
  Map map;
  for (int r0 = 0; r0 < r; r0 += Map::kCap) {
    const int m = r - r0 < Map::kCap ? r - r0 : Map::kCap;
    for (int i = 0; i < m; ++i) map.rows[i] = (int32_t)rows[r0 + i];
    const int64_t off = (int64_t)r0 * n;
    kern<<<m, CHUNK, smem_bytes<D>(), stream>>>(
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
    uint32_t max_state, float logb, float bm1, void* stream) {
  if (r <= 0 || n <= 0) return 0;
  if (depth < 1 || depth > CML_MAX_DEPTH) return (int)cudaErrorInvalidValue;
  // word keys k * words_per_row + word fit 32 bits below 0xFFFFFFFF (a
  // table slot holding word 0xFFFFFFFF would read as FREE)
  if ((uint64_t)depth * (uint64_t)words_per_row >= 0xFFFFFFFFull) {
    return (int)cudaErrorInvalidValue;
  }
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1};
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
