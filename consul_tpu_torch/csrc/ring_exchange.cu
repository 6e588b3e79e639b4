// Ring outbox exchange on one card: D logical shards held as the leading
// axis of each payload plane.
//
// Replaces the Pallas kernel consul_tpu/ops/ring_exchange.py::_ring_kernel.
// There, shard `me` runs D-1 remote DMA hops between chips: hop h copies its
// outbox row (me+h)%D into row `me` of that shard's inbox, and the self row
// (h = 0) is a local copy.  The result is the lax.all_to_all layout: inbox
// row s holds what shard s addressed to `me`.  The reference stacks its C
// payload columns into one [D, D, C, budget] box first so that a hop is one
// DMA descriptor.
//
// Here one launch takes the C planes where the outbox packer left them:
// plane c is read as  src[c] + u*src_u + me*src_me + dst*src_dst  (budget
// int32 per (u, me, dst) segment) and written as  out[c] + u*out_u +
// dst*out_dst + me*out_me, so the packed [U, D_src, pitch] buffers go
// straight into the [U, D_dst, D_src*budget] inbox layout, with no stacking
// copy before and no column slice after.  U is the universe axis of a
// sweep (U independent studies, each over the same D shards; U = 1 for a
// plain run): the reference batches its Pallas ring over it under vmap,
// and here it is one more factor of the segment count, so one launch
// serves every universe and every plane.  The C base pointers and the
// strides travel in two small structs passed by value (kernel parameter
// space), so nothing is staged on the device.  Segment s = ((c*U + u)*D +
// me)*D + h, dst = (me + h) % D, keeps the reference's hop order within
// each universe.
//
// Bound: pure data movement, 2 * C*U*D*D*budget*4 bytes (each word read
// once and written once).  At the sparse 1M membership outbox over 8 shards
// (C = 5, budget = 400,812) that is 513 MB each way, about 0.31 ms at the
// H100's 3.35 TB/s.  The design keeps 16-byte loads and stores in flight on
// all SMs: a persistent grid (8 blocks of 256 threads an SM) walks tiles of
// 1024 int4 vectors, each thread issuing its 4 vector loads of a tile
// before its 4 stores.  Every segment is cut at its destination's 16-byte
// alignment: up to 3 head and 3 tail words are scalar, the body is stored
// as aligned int4.  Where the source is at another phase mod 16 bytes (any
// budget that is not a multiple of 4, such as 40,062 at 100k nodes), the
// body loads the two aligned int4 that straddle each output vector and
// shifts the words in registers; the second load is the neighbouring
// thread's first, so it is served by L1 and DRAM still sees each sector
// once.  No path falls back to one int32 a thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kTileVecs = static_cast<long long>(kThreads) * kVecPerThread;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxPlanes = 8;

struct Planes {
  const int32_t* src[kMaxPlanes];
  int32_t* out[kMaxPlanes];
};

struct Geometry {
  long long budget;                  // int32 words per (u, me, dst) segment
  long long src_univ, src_me, src_dst;  // source plane strides, in words
  long long out_univ, out_dst, out_me;  // output plane strides, in words
  long long tiles_per_seg;
  long long n_tiles;
  int n_shards;
  int n_univ;
};

__device__ __forceinline__ int4 shifted(const int4 a, const int4 b, int ph) {
  // Words ph..ph+3 of the 8-word window (a, b).
  if (ph == 1) return make_int4(a.y, a.z, a.w, b.x);
  if (ph == 2) return make_int4(a.z, a.w, b.x, b.y);
  return make_int4(a.w, b.x, b.y, b.z);
}

__global__ void __launch_bounds__(kThreads)
ring_exchange_planes_kernel(const Planes p, const Geometry g) {
  const int d = g.n_shards;
  const int tid = threadIdx.x;
  for (long long tile = blockIdx.x; tile < g.n_tiles; tile += gridDim.x) {
    const long long seg = tile / g.tiles_per_seg;
    const long long chunk = tile - seg * g.tiles_per_seg;
    const long long dd = static_cast<long long>(d) * d;
    const int h = static_cast<int>(seg % d);
    const int me = static_cast<int>((seg / d) % d);
    const long long u = (seg / dd) % g.n_univ;
    const int c = static_cast<int>(seg / (dd * g.n_univ));
    const int dst = (me + h) % d;
    // Select the plane with constant indices: a runtime index into the
    // parameter struct would copy it to every thread's local memory.
    const int32_t* s = p.src[0];
    int32_t* o = p.out[0];
#pragma unroll
    for (int i = 1; i < kMaxPlanes; ++i) {
      if (c == i) {
        s = p.src[i];
        o = p.out[i];
      }
    }
    s += u * g.src_univ + me * g.src_me + dst * g.src_dst;
    o += u * g.out_univ + dst * g.out_dst + me * g.out_me;
    const long long len = g.budget;

    // Head words until `o` is 16-byte aligned; the body is whole vectors.
    long long head = ((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4;
    if (head > len) head = len;
    const long long n_vec = (len - head) / 4;
    const long long tail = head + n_vec * 4;
    if (chunk == 0) {
      if (tid < head) o[tid] = s[tid];
      if (tid < len - tail) o[tail + tid] = s[tail + tid];
    }

    const int32_t* sb = s + head;
    int4* ob = reinterpret_cast<int4*>(o + head);
    const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(sb) >> 2) & 3);
    const long long v0 = chunk * kTileVecs + tid;
    int4 r[kVecPerThread];
    if (ph == 0) {
      const int4* s4 = reinterpret_cast<const int4*>(sb);
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const long long v = v0 + k * kThreads;
        if (v < n_vec) r[k] = s4[v];
      }
    } else {
      // The aligned vectors around each output vector: words ph..ph+3 of
      // a4[v], a4[v+1].  Both hold at least one word of the segment, so
      // neither leaves the allocation.
      const int4* a4 = reinterpret_cast<const int4*>(sb - ph);
      int4 b[kVecPerThread];
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) {
        const long long v = v0 + k * kThreads;
        if (v < n_vec) {
          r[k] = a4[v];
          b[k] = a4[v + 1];
        }
      }
#pragma unroll
      for (int k = 0; k < kVecPerThread; ++k) r[k] = shifted(r[k], b[k], ph);
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const long long v = v0 + k * kThreads;
      if (v < n_vec) ob[v] = r[k];
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || count <= 0) {
      count = 132;
    }
  }
  return count;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `src` and `out` are host arrays of `n_planes` device pointers.  The
// caller has checked shapes, type, device and strides.
extern "C" int ring_exchange_planes_launch(
    int n_planes, const void* const* src, void* const* out, int n_univ,
    int n_shards, long long budget, long long src_univ, long long src_me,
    long long src_dst, long long out_univ, long long out_dst,
    long long out_me, void* stream) {
  if (n_planes <= 0 || n_planes > kMaxPlanes || n_univ <= 0 ||
      n_shards <= 0 || budget <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes p = {};
  for (int c = 0; c < n_planes; ++c) {
    p.src[c] = static_cast<const int32_t*>(src[c]);
    p.out[c] = static_cast<int32_t*>(out[c]);
  }
  Geometry g;
  g.budget = budget;
  g.src_univ = src_univ;
  g.src_me = src_me;
  g.src_dst = src_dst;
  g.out_univ = out_univ;
  g.out_dst = out_dst;
  g.out_me = out_me;
  g.n_shards = n_shards;
  g.n_univ = n_univ;
  // A segment's body holds at most budget/4 vectors; a segment too short
  // for one still takes a tile for its head and tail words.
  const long long n_vec = budget / 4;
  g.tiles_per_seg = n_vec > 0 ? (n_vec + kTileVecs - 1) / kTileVecs : 1;
  g.n_tiles = g.tiles_per_seg * n_planes * n_univ *
              static_cast<long long>(n_shards) * n_shards;
  long long blocks = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > g.n_tiles) blocks = g.n_tiles;
  ring_exchange_planes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(p, g);
  return static_cast<int>(cudaGetLastError());
}
