// Two designs of the tracker refresh's window read that read each distinct
// (ring, key) once, kept to be measured against the shipped one-thread-a-
// candidate kernel (csrc/window_query.cu, cml_window_query_stacked_rows)
// by tools/window_gather_floor.py, which builds this file with the port's
// flags.  Both take the C signature of cml_window_query_stacked_rows and
// land exactly its results (one float a candidate slot).
//
//   cml_wq_dedup_cluster  one cluster of CL = 8 blocks a ring holds a hash
//       table of the ring's keys across its blocks' shared memory (32,768
//       slots, through distributed shared memory): 1. each thread inserts
//       its PER candidates (the lanes of a warp that hold one key send one
//       compare-and-swap); cluster barrier; 2. each block compacts its
//       filled slots and reduces each key over the buckets into a shared
//       estimate; cluster barrier; 3. every candidate reads its key's
//       estimate.  Passes of 20,480 candidates a ring keep the table at
//       most 5/8 full.
//   cml_wq_dedup_tile     one block of 1,024 threads a tile of at most
//       4,096 of a ring's candidates (tiles of equal size), a shared-memory
//       hash of 8,192 slots: insert, reduce each distinct key of the tile,
//       read back, with two block barriers.  A key in several tiles is
//       reduced once a tile; its repeats hit L2.
//
// The key 0xFFFFFFFF marks a free slot in both, so a candidate holding it
// reads its own cells.
#include <cooperative_groups.h>

#include "window_query.cu"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t FREE_KEY = 0xFFFFFFFFu;

// ---- one cluster a ring ----------------------------------------------------
constexpr int CL = 8;
constexpr int HB = 512;
constexpr int HCAP = 4096;
constexpr int HTOT = CL * HCAP;
constexpr int CPER = 5;
constexpr int SLICE = CPER * HB;
constexpr int PASS = CL * SLICE;
static_assert(8 * PASS <= 5 * HTOT, "a pass fills at most 5/8 of a table");

__device__ __forceinline__ int cluster_insert(cg::cluster_group& cluster,
                                              uint32_t* hkey, uint32_t key) {
  uint32_t h = cml_mix32(key) & (HTOT - 1);
  for (;;) {
    uint32_t* cell = cluster.map_shared_rank(hkey, h / HCAP) + h % HCAP;
    uint32_t cur = *(volatile uint32_t*)cell;
    if (cur == FREE_KEY) {
      cur = atomicCAS(cell, FREE_KEY, key);
      if (cur == FREE_KEY) return (int)h;
    }
    if (cur == key) return (int)h;
    h = (h + 1) & (HTOT - 1);
  }
}

template <int BITS, int TB, int TD>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(HB)
dedup_cluster_kernel(const uint32_t* __restrict__ tables, int buckets,
                     int depth, int wpr, const int32_t* __restrict__ rows,
                     const uint32_t* __restrict__ keys, int n,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int mode_max, RowSeeds seeds,
                     uint32_t width, Counter ctr) {
  __shared__ uint32_t hkey[HCAP];
  __shared__ float hest[HCAP];
  __shared__ uint16_t live[HCAP];
  __shared__ int nlive;
  cg::cluster_group cluster = cg::this_cluster();
  const int me = (int)cluster.block_rank();
  const int r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t* ring =
      tables + (int64_t)rows[r] * buckets * ((int64_t)depth * wpr);
  const uint32_t* kr = keys + (int64_t)r * n;
  const float* wts = weights + (int64_t)r * buckets;
  float* orow = out + (int64_t)r * n;
  for (int p0 = 0; p0 < n; p0 += PASS) {
    for (int s = tid; s < HCAP; s += HB) hkey[s] = FREE_KEY;
    if (tid == 0) nlive = 0;
    cluster.sync();
    const int b0 = p0 + me * SLICE + tid;
    uint32_t key[CPER];
    int slot[CPER];
#pragma unroll
    for (int j = 0; j < CPER; ++j) {
      key[j] = b0 + j * HB < n ? kr[b0 + j * HB] : FREE_KEY;
    }
#pragma unroll
    for (int j = 0; j < CPER; ++j) {
      const int leader = __ffs(__match_any_sync(0xFFFFFFFFu, key[j])) - 1;
      int s = -1;
      if (lane == leader && key[j] != FREE_KEY) {
        s = cluster_insert(cluster, hkey, key[j]);
      }
      slot[j] = __shfl_sync(0xFFFFFFFFu, s, leader);
    }
    cluster.sync();
    for (int s0 = 0; s0 < HCAP; s0 += HB) {
      const bool filled = hkey[s0 + tid] != FREE_KEY;
      const uint32_t ball = __ballot_sync(0xFFFFFFFFu, filled);
      int at = 0;
      if (lane == 0 && ball) at = atomicAdd(&nlive, __popc(ball));
      at = __shfl_sync(0xFFFFFFFFu, at, 0);
      if (filled) {
        live[at + __popc(ball & ((1u << lane) - 1u))] = (uint16_t)(s0 + tid);
      }
    }
    __syncthreads();
    for (int j = tid; j < nlive; j += HB) {
      const int s = live[j];
      hest[s] = ring_estimate<BITS, TB, TD>(ring, buckets, depth, wpr,
                                            hkey[s], wts, mode_max, seeds,
                                            width, ctr);
    }
    cluster.sync();
#pragma unroll
    for (int j = 0; j < CPER; ++j) {
      if (b0 + j * HB < n) {
        orow[b0 + j * HB] =
            slot[j] >= 0
                ? *(cluster.map_shared_rank(hest, slot[j] / HCAP) +
                    slot[j] % HCAP)
                : ring_estimate<BITS, TB, TD>(ring, buckets, depth, wpr,
                                              key[j], wts, mode_max, seeds,
                                              width, ctr);
      }
    }
    cluster.sync();
  }
}

// ---- one block a tile -------------------------------------------------------
constexpr int RT = 1024;
constexpr int TPER = 4;
constexpr int TILE = RT * TPER;
constexpr int LCAP = 2 * TILE;
constexpr size_t TILE_SMEM = (size_t)LCAP * 10 + 16;

template <int BITS, int TB, int TD>
__global__ void __launch_bounds__(RT)
dedup_tile_kernel(const uint32_t* __restrict__ tables, int buckets,
                  int depth, int wpr, const int32_t* __restrict__ rows,
                  const uint32_t* __restrict__ keys, int n, int per_tile,
                  const float* __restrict__ weights, float* __restrict__ out,
                  int mode_max, RowSeeds seeds, uint32_t width, Counter ctr) {
  extern __shared__ uint32_t wsm[];
  uint32_t* hkey = wsm;
  float* hest = (float*)(hkey + LCAP);
  uint16_t* list = (uint16_t*)(hest + LCAP);
  int* nlist = (int*)(list + LCAP);
  const int r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int i0 = blockIdx.x * per_tile;
  const int i1 = min(i0 + per_tile, n);
  const uint32_t* ring =
      tables + (int64_t)rows[r] * buckets * ((int64_t)depth * wpr);
  const uint32_t* kr = keys + (int64_t)r * n;
  const float* wts = weights + (int64_t)r * buckets;
  float* orow = out + (int64_t)r * n;
  for (int s = tid; s < LCAP; s += RT) hkey[s] = FREE_KEY;
  if (tid == 0) *nlist = 0;
  uint32_t key[TPER];
#pragma unroll
  for (int j = 0; j < TPER; ++j) {
    const int i = i0 + j * RT + tid;
    key[j] = i < i1 ? kr[i] : FREE_KEY;
  }
  __syncthreads();
  int slot[TPER], leader[TPER];
#pragma unroll
  for (int j = 0; j < TPER; ++j) {
    leader[j] = __ffs(__match_any_sync(0xFFFFFFFFu, key[j])) - 1;
    int s = -1;
    if (lane == leader[j] && key[j] != FREE_KEY) {
      uint32_t h = cml_mix32(key[j]) & (LCAP - 1);
      for (;;) {
        const uint32_t cur = atomicCAS(hkey + h, FREE_KEY, key[j]);
        if (cur == FREE_KEY) {
          list[atomicAdd(nlist, 1)] = (uint16_t)h;
          break;
        }
        if (cur == key[j]) break;
        h = (h + 1) & (LCAP - 1);
      }
      s = (int)h;
    }
    slot[j] = s;
  }
  __syncthreads();
  const int nl = *nlist;
  for (int e = tid; e < nl; e += RT) {
    const int s = list[e];
    hest[s] = ring_estimate<BITS, TB, TD>(ring, buckets, depth, wpr, hkey[s],
                                          wts, mode_max, seeds, width, ctr);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TPER; ++j) {
    float v = slot[j] >= 0 ? hest[slot[j]] : 0.0f;
    v = __shfl_sync(0xFFFFFFFFu, v, leader[j]);
    const int i = i0 + j * RT + tid;
    if (i < i1) {
      if (key[j] == FREE_KEY) {
        v = ring_estimate<BITS, TB, TD>(ring, buckets, depth, wpr, key[j],
                                        wts, mode_max, seeds, width, ctr);
      }
      orow[i] = v;
    }
  }
}

// rows: a device int32 (r,) copy of the ring map (the tool's own upload:
// these designs are measured on the card, not shipped)
template <int BITS, int TB, int TD>
int launch_dedup(int tile, const uint32_t* tables, int r, int buckets,
                 int depth, int wpr, const int32_t* rows,
                 const uint32_t* keys, int n, const float* weights,
                 float* out, int mode_max, const RowSeeds& seeds,
                 uint32_t width, const Counter& ctr, cudaStream_t stream) {
  if (tile) {
    auto* kern = dedup_tile_kernel<BITS, TB, TD>;
    static bool sized[CML_MAX_DEVICES] = {};
    const cudaError_t err = cml_smem_opt_in(kern, (int)TILE_SMEM, sized);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (n + TILE - 1) / TILE;
    const int per_tile = (n + tiles - 1) / tiles;
    kern<<<dim3(tiles, r), RT, TILE_SMEM, stream>>>(
        tables, buckets, depth, wpr, rows, keys, n, per_tile, weights, out,
        mode_max, seeds, width, ctr);
  } else {
    dedup_cluster_kernel<BITS, TB, TD><<<dim3(CL, r), HB, 0, stream>>>(
        tables, buckets, depth, wpr, rows, keys, n, weights, out, mode_max,
        seeds, width, ctr);
  }
  return (int)cudaGetLastError();
}

int dedup_entry(int tile, const void* tables, int r, int buckets, int depth,
                int wpr, const void* rows, const void* keys, int n,
                const void* weights, void* out, int mode_max,
                const uint32_t* seeds, uint32_t width, int bits,
                int log_counter, uint32_t max_state, float logb, float bm1,
                void* stream) {
  if (r <= 0 || n <= 0) return 0;
  if (r > 65535 || buckets != 8 || depth != 2) {
    return (int)cudaErrorInvalidValue;  // the windowed path's geometry
  }
  const RowSeeds rs = cml_seeds(seeds, depth);
  const Counter ctr{log_counter, max_state, logb, bm1};
  auto* tb = (const uint32_t*)tables;
  auto* rw = (const int32_t*)rows;
  auto* ks = (const uint32_t*)keys;
  auto* wt = (const float*)weights;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  switch (bits) {
    case 8:
      return launch_dedup<8, 8, 2>(tile, tb, r, buckets, depth, wpr, rw, ks,
                                   n, wt, o, mode_max, rs, width, ctr, s);
    case 16:
      return launch_dedup<16, 8, 2>(tile, tb, r, buckets, depth, wpr, rw, ks,
                                    n, wt, o, mode_max, rs, width, ctr, s);
    case 32:
      return launch_dedup<32, 8, 2>(tile, tb, r, buckets, depth, wpr, rw, ks,
                                    n, wt, o, mode_max, rs, width, ctr, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The signature of cml_window_query_stacked_rows, but rows a device int32
// (r,) tensor's pointer.
#define CML_DEDUP_ENTRY(NAME, TILE_DESIGN)                                    \
  extern "C" int NAME(const void* tables, int r, int buckets, int depth,     \
                      int words_per_row, const void* rows, const void* keys, \
                      int n, const void* weights, void* out, int mode_max,   \
                      const uint32_t* seeds, uint32_t width, int bits,       \
                      int log_counter, uint32_t max_state, float logb,       \
                      float bm1, void* stream) {                             \
    return dedup_entry(TILE_DESIGN, tables, r, buckets, depth,               \
                       words_per_row, rows, keys, n, weights, out, mode_max, \
                       seeds, width, bits, log_counter, max_state, logb,     \
                       bm1, stream);                                         \
  }

CML_DEDUP_ENTRY(cml_wq_dedup_cluster, 0)
CML_DEDUP_ENTRY(cml_wq_dedup_tile, 1)
