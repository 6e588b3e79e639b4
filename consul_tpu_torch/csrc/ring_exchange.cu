// Ring outbox exchange on one card: D logical shards held as the leading
// axis of one tensor.
//
// Replaces the Pallas kernel consul_tpu/ops/ring_exchange.py::_ring_kernel.
// There, shard `me` runs D-1 remote DMA hops between chips: hop h copies its
// outbox row (me+h)%D into row `me` of that shard's inbox, and the self row
// (h = 0) is a local copy.  The result is the lax.all_to_all layout: inbox
// row s holds what shard s addressed to `me`.
//
// On one card every shard's outbox is a row block of
//     box[D_src, D_dst, C, budget]   (int32, contiguous)
// and the kernel writes
//     inbox[D_dst, D_src, C, budget] with inbox[dst, me] = box[me, dst],
// i.e. the D*D row-block copies of the rotated-pairwise hop schedule, all in
// one launch.  Block (x, h, me) copies the x-th chunk of hop h of shard me,
// dst = (me + h) % D; each row block is C*budget contiguous int32.
//
// Bound: pure data movement.  It reads the box once and writes the inbox
// once, 2 * D*D*C*budget*4 bytes; at the 1M-node broadcast on 8 shards
// (C = 1, budget = 125,000) that is 32 MB each way, about 19 us at the
// H100's 3.35 TB/s.  The design therefore only has to keep enough 16-byte
// loads and stores in flight: each row is cut into chunks so the grid holds
// about a thousand blocks, and each thread moves int4 vectors where both
// row pointers are 16-byte aligned (C*budget a multiple of 4), with scalar
// copies for the tail and for misaligned rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ring_exchange_kernel(const int32_t* __restrict__ box,
                     int32_t* __restrict__ inbox, int n_shards,
                     long long row_len, long long chunk) {
  const int h = blockIdx.y;
  const int me = blockIdx.z;
  const int dst = (me + h) % n_shards;
  const int32_t* src =
      box + (static_cast<long long>(me) * n_shards + dst) * row_len;
  int32_t* out =
      inbox + (static_cast<long long>(dst) * n_shards + me) * row_len;

  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  if (lo >= row_len) return;
  const long long hi = lo + chunk < row_len ? lo + chunk : row_len;

  long long i = lo;
  // `chunk` is a multiple of 4, so src + lo and out + lo keep the row
  // pointers' 16-byte alignment.
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (aligned) {
    const long long n_vec = (hi - lo) / 4;
    const int4* s4 = reinterpret_cast<const int4*>(src + lo);
    int4* o4 = reinterpret_cast<int4*>(out + lo);
    for (long long v = threadIdx.x; v < n_vec; v += kThreads) {
      o4[v] = s4[v];
    }
    i = lo + n_vec * 4;
  }
  for (long long j = i + threadIdx.x; j < hi; j += kThreads) {
    out[j] = src[j];
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The caller has checked shapes, type, device and contiguity.
extern "C" int ring_exchange_launch(const int32_t* box, int32_t* inbox,
                                    int n_shards, long long row_len,
                                    int chunks_per_row, void* stream) {
  if (n_shards <= 0 || row_len <= 0 || chunks_per_row <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long chunk = (row_len + chunks_per_row - 1) / chunks_per_row;
  chunk = (chunk + 3) / 4 * 4;
  dim3 grid(chunks_per_row, n_shards, n_shards);
  ring_exchange_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      box, inbox, n_shards, row_len, chunk);
  return static_cast<int>(cudaGetLastError());
}
