// The CHUNK-sequential conservative update of one table row, as one block's
// chain: the body shared by the three update kernels (fused_update_rows.cu:
// the row-mapped update, uniforms read from a tensor; fused_update_score.cu:
// the tracked flush's update and the untracked all-active update, uniforms
// drawn in the kernel).  Each kernel is a __global__ that hands this chain
// its dynamic shared memory, its row map and its uniform source.
//
// Semantics kept from the reference: CHUNK = 1024 keys is part of the
// result.  Within a chunk every key reads the row minima from before the
// chunk and writes resolve by max; each chunk sees all earlier chunks'
// writes; entries with mult == 0 write nothing.  Built with -fmad=false
// (common.cuh), so cell states equal the plain version's.
//
// What sets its time on the H100 is not bytes but the chain of N / CHUNK
// rounds each row runs in order: a chunk reads what the chunks before it
// wrote, so one block walks a row's chunks one after another, and the
// row's random word reads and stores (about 8 SM cycles each, measured)
// sit on that one SM.  A chunk's round is a gather from L2, nfold, a merge
// in shared memory and two barriers, on the live slots alone:
//
//   1. Before the first chunk, each thread loads its slot of every
//      chunk's mult, sixteen chunks in flight at a time; the live slots
//      are compacted in chunk order into shared memory (their d columns,
//      hashed here once, mult and uniform, the uniform taken at the slot's
//      ORIGINAL position; a drawn one in a dense pass over the compacted
//      slots) by a block-wide prefix sum of per-warp ballots,
//      and their d table words asked of L2 (prefetch.global.L2).  The
//      block also tabulates expm1(s log b) and exp(-(s log b)) of the
//      first STATE_TAB states (XLA's polynomials, xla_f32.cuh).  Dead slots (every duplicate of a sorted dedup
//      batch, and the ring's stale padding) take no part in a chunk, and a
//      chunk without a live slot is skipped.  A row of more live slots or
//      chunks than its kernel's plan holds, or of depth > 2, skips this
//      step, and each chunk's threads take their own slots as they come.
//   2. Chunk by chunk, on the chunk's live slots: gather the d words
//      (__ldcg), nfold (its expm1 / exp of a state in the tables read
//      from them: the same floats, a lookup for a chain of
//      transcendentals; one log1p a cell stays), then merge the new states per 32-bit word in a
//      shared-memory table instead of a compare-and-swap on L2: one
//      64-bit compare-and-swap claims a word and writes (word, value),
//      the value being the word as read with the new state in its lane;
//      another slot of the chunk on the same word merges by per-lane max
//      (__vmaxu2 / __vmaxu4; max for 32-bit cells).  Barrier; the slot
//      that claimed each word stores it once with a plain 32-bit store
//      and frees its table slot; barrier, which orders those stores
//      before the next chunk's __ldcg reads.
//
// Each kernel picks its plan (live slots and chunks a compacted row
// holds, states tabulated, L2-only streamed reads): see the Plan note
// below and the kernels' sources.  Both plans stay under 196 KB of
// shared memory, past which L1 shrinks to 28 KB: measured on the H100,
// the window flush's kernel took 15% longer under a 205 KB plan than
// under its own 135 KB one, and kernel 5 7% longer under a 221 KB plan
// than under a 184 KB one.
#pragma once

#include "common.cuh"

namespace {

constexpr int CHUNK = 1024;
constexpr unsigned long long FREE = ~0ull;  // a free table slot
constexpr uint32_t OWNER = 1u << 31;        // merge_slot: claimed here

// One chunk's written words: at most CHUNK * D, in a table twice that.
template <int D>
__host__ __device__ constexpr int table_slots() {
  return 2 * CHUNK * D;
}

// A chain's plan: a struct of constants that each kernel defines.
//   kLive    live slots a compacted row holds, over at most kChunks chunks;
//   kStates  log-counter states whose expm1 and exp are tabulated;
//   kL2Only  compaction streams the row's mult and keys past L1 (__ldcg),
//            leaving L1 to the gathers in flight.

// The merge table, the state tables, and for depth <= 2 the compacted
// live slots with their per-(chunk, warp) counts and scan scratch.
template <int D, typename Plan>
constexpr size_t chain_smem_bytes() {
  return table_slots<D>() * sizeof(unsigned long long) +
         2 * Plan::kStates * sizeof(float) +
         (D <= 2 ? (4 * Plan::kLive + 33 * Plan::kChunks + 33) *
                       sizeof(uint32_t)
                 : 0);
}

// A read of the row's streamed inputs: at L2 only under an L2-only plan.
template <bool L2_ONLY, typename T>
__device__ __forceinline__ T stream_load(const T* p) {
  if constexpr (L2_ONLY) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// Uniform sources of the chain.  `at(map, r, i, n)`: the uniform of batch
// row r (of this launch) at sorted position i, of n.
//
// UnifLoad: read from an (R, n) float32 tensor (p: this launch's first
// row).
//
// kDeferred: compaction leaves each live slot's original position where
// its uniform goes and a dense pass over the compacted slots makes the
// uniforms after it (a draw costs a warp its 20 threefry rounds, which a
// sparse live mask would make every warp pay for every chunk); a load
// is made at once, in the compaction's batched loads.
struct UnifLoad {
  static constexpr bool kDeferred = false;
  const float* __restrict__ p;
  template <typename Map>
  __device__ __forceinline__ float at(const Map&, int r, int i,
                                      int n) const {
    return p[(int64_t)r * n + i];
  }
};

// UnifDraw: drawn here, element (map.urows[r], i) of the flush's
// (total, n) threefry draw under the key (k1, k2) (core/prng.py
// uniform_rows): flat index urows[r] * n + i, in 64 bits.
struct UnifDraw {
  static constexpr bool kDeferred = true;
  uint32_t k1, k2;
  template <typename Map>
  __device__ __forceinline__ float at(const Map& map, int r, int i,
                                      int n) const {
    const uint64_t idx =
        (uint64_t)(uint32_t)map.urows[r] * (uint64_t)n + (uint64_t)i;
    return cml_uniform(k1, k2, idx);
  }
};

// The states outside the tables take the functions themselves, behind a
// call the compiler does not evaluate ahead of the branch.
__device__ __noinline__ float em_slow(float s, Counter c) {
  return cml_em(s, c);
}

__device__ __noinline__ float ep_slow(float s, Counter c) {
  return cml_ep(s, c);
}

// cml_nfold, with expm1(s log b) and exp(-(s log b)) of states below `ts`
// read from tables the block filled with the same functions (so the same
// floats): a log counter's transcendentals but one log1p become lookups.
__device__ __forceinline__ uint32_t nfold_tab(uint32_t state, float n,
                                              float u, const Counter& c,
                                              const float* emtab,
                                              const float* eptab, int ts) {
  if (!c.log) return cml_nfold(state, n, u, c);
  const float fts = (float)ts;
  return cml_nfold_log(
      state, n, u, c,
      [&](float x) { return x < fts ? emtab[(int)x] : em_slow(x, c); },
      [&](float x) { return x < fts ? eptab[(int)x] : ep_slow(x, c); });
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

__device__ __forceinline__ uint32_t width_mask(uint32_t width) {
  return (width & (width - 1u)) == 0u ? width - 1u : 0u;
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
// ccol holding row k's column at [k * LIVE + slot], and ask L2 for their
// words.  False, having written nothing, when the row has more than LIVE
// (the plan's kLive) live slots.
template <int BITS, typename Plan, typename Map, typename Unif>
__device__ __forceinline__ bool compact_live(
    const uint32_t* tab, int depth, int wpr, const uint32_t* __restrict__ kr,
    const float* __restrict__ mr, int n, int nch, const RowSeeds& seeds,
    uint32_t width, uint32_t wmask, const Map& map, const Unif& unif,
    uint32_t* ccol, float* cmu, float* cu, uint32_t* cnt, uint32_t* starts,
    uint32_t* sums) {
  constexpr int LIVE = Plan::kLive;
  constexpr bool L2 = Plan::kL2Only;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // live counts per (chunk, warp), sixteen chunks' mults in flight
  uint64_t mine = 0ull;
  for (int j0 = 0; j0 < nch; j0 += 16) {
    float m16[16];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const int i = (j0 + g) * CHUNK + tid;
      m16[g] = j0 + g < nch && i < n ? stream_load<L2>(mr + i) : 0.0f;
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
  if (total > (uint32_t)LIVE) return false;  // after scan's barrier
  for (int j0 = 0; j0 < nch; j0 += 8) {
    uint32_t at[8], k8[8];
    float m8[8], u8[8];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const bool live = (mine >> (j0 + g)) & 1ull;
      const uint32_t ball = __ballot_sync(0xFFFFFFFFu, live);
      at[g] = LIVE;
      if (live) {
        const int i = (j0 + g) * CHUNK + tid;
        at[g] = cnt[(j0 + g) * 32 + warp] +
                __popc(ball & ((1u << lane) - 1u));
        k8[g] = stream_load<L2>(kr + i);
        m8[g] = stream_load<L2>(mr + i);
        // the uniform at the slot's original position, or that position
        u8[g] = Unif::kDeferred ? __uint_as_float((uint32_t)i)
                                : unif.at(map, blockIdx.x, i, n);
      }
    }
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      if (at[g] < (uint32_t)LIVE) {
        cmu[at[g]] = m8[g];
        cu[at[g]] = u8[g];
        for (int k = 0; k < depth; ++k) {
          const uint32_t col = col_at(k8[g], seeds.s[k], width, wmask);
          ccol[k * LIVE + at[g]] = col;
          prefetch_l2(tab + (int64_t)k * wpr + cml_word_index<BITS>(col));
        }
      }
    }
  }
  if (tid < nch) starts[tid] = cnt[tid * 32];
  if (tid == 0) starts[nch] = total;
  __syncthreads();
  if constexpr (Unif::kDeferred) {  // the caller's barrier follows
    for (uint32_t e = tid; e < total; e += CHUNK) {
      cu[e] = unif.at(map, blockIdx.x, (int)__float_as_uint(cu[e]), n);
    }
  }
  return true;
}

// Merge a chunk slot's new state `nv` into `table`: per row k, the word as
// read with the state in its lane, if that raises it; own[k]: 1 + the
// table slot this thread claimed (it stores the word), else 0.
template <int BITS, int D>
__device__ __forceinline__ void merge_state(
    unsigned long long* table, uint32_t slots, int depth, int wpr,
    uint32_t nv, const uint32_t* col, const uint32_t* word, uint32_t* own) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    own[k] = 0u;
    if (k < depth && nv > 0u) {
      const uint32_t want =
          lane_max<BITS>(word[k], nv << cell_shift<BITS>(col[k]));
      if (want != word[k]) {
        const uint32_t s = merge_slot<BITS>(
            table, slots,
            (uint32_t)k * (uint32_t)wpr + cml_word_index<BITS>(col[k]),
            want);
        if (s & OWNER) own[k] = (s & ~OWNER) + 1u;
      }
    }
  }
}

// The new state of a slot with multiplicity mu > 0 (0 for a dead slot)
// from its words as read.
template <int BITS, int D>
__device__ __forceinline__ uint32_t slot_state(
    int depth, float mu, float u, const uint32_t* col, const uint32_t* word,
    const Counter& ctr, const float* dtab, const float* etab, int ts) {
  if (!(mu > 0.0f)) return 0u;
  uint32_t cmin = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    if (k < depth) {
      const uint32_t v = cml_cell<BITS>(word[k], col[k]);
      cmin = v < cmin ? v : cmin;
    }
  }
  return nfold_tab(cmin, mu, u, ctr, dtab, etab, ts);
}

// The chain of block blockIdx.x: batch row blockIdx.x (keys / mult at
// row * n) lands CHUNK-sequentially in table map.rows[blockIdx.x].
// D: the largest depth this instance serves (the loops run k < depth);
// Plan: the chain's plan.  smem: chain_smem_bytes<D, Plan>() of dynamic
// shared memory.  Launch with CHUNK threads.
template <int BITS, int D, typename Plan, typename Map, typename Unif>
__device__ __forceinline__ void update_chain(
    unsigned long long* smem, uint32_t* __restrict__ tables, int depth,
    int wpr, const uint32_t* __restrict__ keys,
    const float* __restrict__ mult, int n, const RowSeeds& seeds,
    uint32_t width, const Counter& ctr, const Map& map, const Unif& unif) {
  constexpr uint32_t SLOTS = table_slots<D>();
  constexpr int LIVE = Plan::kLive;
  constexpr int MAX_CHUNKS = Plan::kChunks;
  constexpr int STATE_TAB = Plan::kStates;
  unsigned long long* table = smem;  // (word << 32 | value), FREE
  float* dtab = (float*)(smem + SLOTS);  // expm1(s log b), s < STATE_TAB
  float* etab = dtab + STATE_TAB;        // exp(-(s log b))
  uint32_t* ccol = (uint32_t*)(etab + STATE_TAB);  // compacted live slots
  float* cmu = (float*)(ccol + 2 * LIVE);
  float* cu = cmu + LIVE;
  uint32_t* cnt = (uint32_t*)(cu + LIVE);          // per (chunk, warp)
  uint32_t* starts = cnt + 32 * MAX_CHUNKS;        // first slot a chunk
  uint32_t* sums = starts + MAX_CHUNKS + 1;        // scan scratch
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const uint32_t wmask = width_mask(width);
  uint32_t* tab = tables + (int64_t)map.rows[row] * depth * (int64_t)wpr;
  const int64_t base = (int64_t)row * n;
  const uint32_t* kr = keys + base;
  const float* mr = mult + base;
  for (uint32_t s = tid; s < SLOTS; s += CHUNK) table[s] = FREE;
  const int ts = ctr.log ? min((int)ctr.max_state + 1, STATE_TAB) : 0;
  for (int s = tid; s < ts; s += CHUNK) {
    dtab[s] = cml_em((float)s, ctr);
    etab[s] = cml_ep((float)s, ctr);
  }
  const int nch = (n + CHUNK - 1) / CHUNK;
  bool compacted = false;
  if constexpr (D <= 2) {
    if (depth <= 2 && nch <= MAX_CHUNKS) {
      compacted = compact_live<BITS, Plan>(tab, depth, wpr, kr, mr, n, nch,
                                           seeds, width, wmask, map, unif,
                                           ccol, cmu, cu, cnt, starts, sums);
    }
  }
  __syncthreads();

  for (int c = 0; c < nch; ++c) {
    // this thread's slot of chunk c: a compacted live slot, its columns
    // hashed before the loop, or its own slot
    float mu = 0.0f, u = 0.0f;
    uint32_t col[D], word[D], own[D];
    if (compacted) {
      const uint32_t lo = starts[c], hi = starts[c + 1];
      if (lo == hi) continue;  // no live slot: the same for every thread
      const uint32_t e = lo + tid;
      if (e < hi) {
        mu = cmu[e];
        u = cu[e];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          if (k < depth) col[k] = ccol[k * LIVE + e];
        }
      }
    } else {
      const int i = c * CHUNK + tid;
      if (i < n) {
        mu = mr[i];
        if (mu > 0.0f) {
          const uint32_t key = kr[i];
          u = unif.at(map, row, i, n);
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (k < depth) col[k] = col_at(key, seeds.s[k], width, wmask);
          }
        }
      }
    }
    if (mu > 0.0f) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < depth) {
          word[k] = __ldcg(tab + (int64_t)k * wpr +
                           cml_word_index<BITS>(col[k]));
        }
      }
    }
    const uint32_t nv =
        slot_state<BITS, D>(depth, mu, u, col, word, ctr, dtab, etab, ts);
    // merge: no device-memory write yet, so no barrier before it
    merge_state<BITS, D>(table, SLOTS, depth, wpr, nv, col, word, own);
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

// Host side: word keys k * words_per_row + word of the merge table fit 32
// bits below 0xFFFFFFFF (a table slot holding word 0xFFFFFFFF would read
// as FREE).
static inline bool chain_words_fit(int depth, int words_per_row) {
  return (uint64_t)depth * (uint64_t)words_per_row < 0xFFFFFFFFull;
}

}  // namespace
