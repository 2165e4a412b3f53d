// queue_append / queue_append_dense: land R ragged key microbatches in the
// device ring, in place: queue[rows[i], fill[i] + j] = keys[i, j] for
// j < count[i]; every other ring cell keeps its value.
//
// Replaces queue_append_pallas (src/repro/kernels/sketch.py:526, body
// _queue_append_kernel :482, _shift_to_fill :502) and
// queue_append_dense_pallas (:587, body _queue_append_dense_kernel :567,
// rows == arange(T)).  The Pallas versions shift each batch to its fill
// offset in a capw-wide staging buffer and then do a masked copy of whole
// ring rows; here each key is written straight to its slot, so no staging
// buffer is built and only the appended cells are touched.
//
// Bound on the H100: bytes.  The least traffic is one 4-byte read and one
// 4-byte write per appended key, microseconds for a full-plane append, so
// what costs time is the launch path around the kernel.  Design:
//
//   * The per-row meta rides in the kernel's parameter block, as the
//     Pallas kernel's rides in SMEM through scalar prefetch: a
//     __grid_constant__ struct of int32 arrays (rows / fill / count, or
//     fill / count for the dense kernel) filled on the host from the
//     wrapper's checked int64 host array.  No device buffer, no host-to-device copy, no synchronize.
//     A call of at most SMALL_ROWS rows passes a struct of that many
//     (under 1 KB: a launch's host cost grows with its parameter block,
//     PERF.md); a larger one
//     passes CML_APPEND_MAX_ROWS rows a launch and issues consecutive
//     launches of at most that many rows; rows are unique within a call,
//     so the launches touch disjoint cells and the split is exact.
//   * Grid (key tiles, R): a block covers KEYS_PER_BLOCK keys of ONE row,
//     so its row's entries are one constant-bank address per warp (a
//     broadcast) and the access width below is uniform across the block.
//   * 16-byte accesses (uint4, 4 keys a thread) when the row's fill, the
//     batch width n and capw are multiples of 4 and both base pointers are
//     16-byte aligned; 4-byte accesses, coalesced along the keys,
//     otherwise.  Either way the tail is masked against the row's count
//     and no key at or past count is read.
//
// Caller contract (checked by the wrappers in kernels/sketch.py): rows
// unique within a call, fill + count <= capw, count <= n.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KEYS_PER_THREAD = 4;
constexpr int KEYS_PER_BLOCK = THREADS * KEYS_PER_THREAD;

// The per-row meta of one launch, by value.  Two sizes of each: calls of
// at most SMALL_ROWS rows (every append of the main path) pass a struct
// of under 1 KB; larger calls pass CML_APPEND_MAX_ROWS rows a launch.
constexpr int SMALL_ROWS = 64;

template <int CAP>
struct RowsMeta {  // queue_append: batch row i -> ring row rows[i]
  static constexpr int kCap = CAP;
  int32_t rows[CAP];
  int32_t fill[CAP];
  int32_t count[CAP];
};

template <int CAP>
struct DenseMeta {  // queue_append_dense: batch row i -> ring row row0 + i
  static constexpr int kCap = CAP;
  int32_t fill[CAP];
  int32_t count[CAP];
};

template <int CAP>
__device__ __forceinline__ int64_t ring_row(const RowsMeta<CAP>& m, int r,
                                            int) {
  return m.rows[r];
}

template <int CAP>
__device__ __forceinline__ int64_t ring_row(const DenseMeta<CAP>&, int r,
                                            int row0) {
  return (int64_t)row0 + r;
}

template <typename Meta>
__global__ void __launch_bounds__(THREADS)
queue_append_kernel(uint32_t* __restrict__ queue, int capw,
                    const uint32_t* __restrict__ keys, int n, int row0,
                    int vec, const __grid_constant__ Meta meta) {
  const int r = blockIdx.y;
  const int count = meta.count[r];
  const int base = blockIdx.x * KEYS_PER_BLOCK;
  if (base >= count) return;
  const int fill = meta.fill[r];
  uint32_t* dst = queue + ring_row(meta, r, row0) * capw + fill;
  const uint32_t* src = keys + (int64_t)r * n;
  if (vec && (fill & 3) == 0) {
    const int j = base + threadIdx.x * KEYS_PER_THREAD;
    if (j + KEYS_PER_THREAD <= count) {
      *reinterpret_cast<uint4*>(dst + j) =
          __ldg(reinterpret_cast<const uint4*>(src + j));
    } else {
      for (int k = j; k < count; ++k) dst[k] = __ldg(src + k);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < KEYS_PER_THREAD; ++i) {
    const int j = base + i * THREADS + threadIdx.x;
    if (j < count) dst[j] = __ldg(src + j);
  }
}

// Host side: copy each chunk of at most Meta::kCap rows' meta into the
// by-value struct and launch it (rows is unread for DenseMeta).
template <typename Meta, bool ROWS>
int launch_chunks(void* queue, int capw, const void* keys, int r, int n,
                  const int64_t* rows, const int64_t* fill,
                  const int64_t* count, void* stream) {
  const bool vec = n % 4 == 0 && capw % 4 == 0 &&
                   (uintptr_t)queue % 16 == 0 && (uintptr_t)keys % 16 == 0;
  Meta meta;
  for (int r0 = 0; r0 < r; r0 += Meta::kCap) {
    const int m = r - r0 < Meta::kCap ? r - r0 : Meta::kCap;
    int max_count = 0;
    for (int i = 0; i < m; ++i) {
      if constexpr (ROWS) meta.rows[i] = (int32_t)rows[r0 + i];
      meta.fill[i] = (int32_t)fill[r0 + i];
      meta.count[i] = (int32_t)count[r0 + i];
      if (meta.count[i] > max_count) max_count = meta.count[i];
    }
    if (max_count == 0) continue;
    const dim3 grid((max_count + KEYS_PER_BLOCK - 1) / KEYS_PER_BLOCK, m);
    queue_append_kernel<Meta><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (uint32_t*)queue, capw, (const uint32_t*)keys + (int64_t)r0 * n, n,
        r0, vec ? 1 : 0, meta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <template <int> class Meta, bool ROWS>
int launch(void* queue, int capw, const void* keys, int r, int n,
           const int64_t* rows, const int64_t* fill, const int64_t* count,
           void* stream) {
  if (r <= SMALL_ROWS) {
    return launch_chunks<Meta<SMALL_ROWS>, ROWS>(queue, capw, keys, r, n,
                                                 rows, fill, count, stream);
  }
  return launch_chunks<Meta<CML_APPEND_MAX_ROWS>, ROWS>(
      queue, capw, keys, r, n, rows, fill, count, stream);
}

}  // namespace

// meta: host int64 (3, r) array, rows r entries then fill then count,
// each value checked by the caller to fit the ring (so in int32).
extern "C" int cml_queue_append(void* queue, int capw, const void* keys,
                                int r, int n, const int64_t* meta,
                                void* stream) {
  return launch<RowsMeta, true>(queue, capw, keys, r, n, meta, meta + r,
                                meta + 2 * (int64_t)r, stream);
}

// meta: host int64 (2, t) array, fill t entries then count.
extern "C" int cml_queue_append_dense(void* queue, int capw, const void* keys,
                                      int t, int n, const int64_t* meta,
                                      void* stream) {
  return launch<DenseMeta, false>(queue, capw, keys, t, n, nullptr, meta,
                                  meta + t, stream);
}
