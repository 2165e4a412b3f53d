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
// 4-byte write per appended key.  Design: grid (key blocks, R), 256
// threads per block along the keys of one batch, so both the key reads
// and the ring writes are contiguous runs.  The (3, R) int32 meta (row,
// fill, count) lies on the device; the caller contract is unchanged:
// rows unique within a call and fill + count <= capw.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
queue_append_kernel(uint32_t* __restrict__ queue, int capw,
                    const uint32_t* __restrict__ keys, int n,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ fill,
                    const int32_t* __restrict__ count) {
  const int r = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || j >= count[r]) return;
  const int64_t row = rows ? rows[r] : r;
  queue[row * capw + fill[r] + j] = keys[(int64_t)r * n + j];
}

int launch(void* queue, int capw, const void* keys, int r, int n,
           int max_count, const void* rows, const void* fill,
           const void* count, void* stream) {
  if (r <= 0 || max_count <= 0) return 0;
  const dim3 block(256);
  const dim3 grid((max_count + 255) / 256, r);
  queue_append_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (uint32_t*)queue, capw, (const uint32_t*)keys, n,
      (const int32_t*)rows, (const int32_t*)fill, (const int32_t*)count);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cml_queue_append(void* queue, int capw, const void* keys,
                                int r, int n, int max_count, const void* rows,
                                const void* fill, const void* count,
                                void* stream) {
  return launch(queue, capw, keys, r, n, max_count, rows, fill, count,
                stream);
}

extern "C" int cml_queue_append_dense(void* queue, int capw, const void* keys,
                                      int t, int n, int max_count,
                                      const void* fill, const void* count,
                                      void* stream) {
  return launch(queue, capw, keys, t, n, max_count, nullptr, fill, count,
                stream);
}
