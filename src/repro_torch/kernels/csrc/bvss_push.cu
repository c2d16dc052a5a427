// BVSS push for Hopper (sm_90a): two entries of one library.
//
// bvss_push_launch, the pull against a one-hot frontier byte.  Each queued
// entry b is one (frontier vertex, VSS) pair; the frontier byte is
// 1 << bits[b], the vertex's bit inside its own slice set.
//
// Replaces: repro/kernels/bvss_push.py::bvss_push (_push_kernel_lanes), the
// push side of the direction-optimizing hybrid (DESIGN section 2.8).
//
// Bound on an H100: memory, as for the pull: 128 B of masks and 4 B of bit
// index read, 32/sigma * 32 B of hits written per entry.  On the main path
// the queue is push_cap * max_vss_per_set entries (128 on a road grid), a
// ~33 KB problem, so in practice the launch itself is the cost.
//
// Design: the pull kernel's warp-per-VSS body (bvss_lanes.cuh), with the
// one-hot byte built in the kernel from the (B,) bit-index vector, so the
// engine ships 4 B per entry and no materialised frontier byte.
//
// bvss_push_level_launch, the whole single-source push level in one launch:
// for every set bit v of the packed frontier F and every VSS r of v's slice
// set ([start[v], end[v])), each slot of r that meets the one-hot byte
// 1 << (v % sigma) stores into its row: lvl where the row's level is still
// above lvl (eager), or 1 into the row's mark (lazy).  It leaves in levels /
// marks what the reference's push level (vertex compaction, queue
// expansion, bvss_push, scatter; repro/core/bfs.py::_make_hybrid_step)
// leaves there, on every real row.
//
// Bound: memory.  The frontier words are read once (512 KB on a 4M-vertex
// graph), then 8 B of start/end per frontier vertex, 128 B of mask per
// (vertex, VSS) pair, 4 B of row id and (eager) 4 B of level per hit slot,
// and 4 B (eager) or 1 B (lazy) written per row it sets: about 0.2 us at
// 3.35 TB/s for a 128-vertex frontier.  What is left above that is latency:
// the launch, and a chain of dependent loads (frontier word, VSS range,
// mask, row id, level) that no amount of parallelism shortens.
//
// Design: no vertex queue, no expansion, no hits tensor and no host work
// between them, so a push level is one launch whatever its frontier.  The
// hard part is that a frontier is not spread over the graph: after RCM, a
// grid's frontier of 128 vertices is 128 consecutive ids, 4 frontier
// words.  A warp that walked its words' set bits one vertex at a time, the
// whole warp on one VSS, would run those 128 load chains one after another.
// So a block owns 256 frontier words (one a thread, coalesced), compacts
// their set bits into a vertex list in shared memory (a block prefix sum of
// popcounts), expands the list into (vertex, VSS) pairs by a second prefix
// sum over the VSS counts, and gives each pair to one thread (push_pair in
// bvss_lanes.cuh): a frontier's pairs run side by side, however few words
// they sit in and however many VSSs one vertex has.  A thread resolves its
// pair's hits kHitBatch at a time (row ids, then levels, then stores), so a
// pair waits on a few memory latencies, not two a hit.  A block takes its
// vertices in rounds of kListCap, so shared memory stays at 20 KB and a
// dense (forced) frontier just takes more rounds.  Vertices past n, the
// padding bits of the last word, count as the dummy vertex n, whose VSS
// range is empty.
#include "bvss_lanes.cuh"

namespace {

using bvss::kWarpsPerBlock;

template <int SIGMA>
__global__ void bvss_push_kernel(const uint32_t* __restrict__ masks,
                                 const int32_t* __restrict__ bits,
                                 uint8_t* __restrict__ hits, long long B) {
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  // a bit index outside [0, 32) has no one-hot byte (uint32 shift semantics)
  const uint32_t bit = static_cast<uint32_t>(__ldg(bits + b));
  bvss::emit_hits<SIGMA>(masks, bit < 32u ? (1u << bit) : 0u, hits, b,
                         threadIdx.x & 31);
}

template <int SIGMA>
void launch(const void* masks, const void* bits, void* hits, long long B,
            cudaStream_t stream) {
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bvss_push_kernel<SIGMA><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                            stream>>>(
      static_cast<const uint32_t*>(masks), static_cast<const int32_t*>(bits),
      static_cast<uint8_t*>(hits), B);
}

constexpr int kLevelThreads = 256;  // frontier words a block owns
constexpr int kListCap = 1024;      // vertices a block takes in one round
constexpr int kPerThread = kListCap / kLevelThreads;

// Exclusive prefix sum over the block of one value a thread; *total gets
// the block's sum.  Ends in a barrier, so s_warp can be reused at once.
__device__ __forceinline__ int block_exclusive_sum(int x, int* s_warp,
                                                   int* total) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kWarps = kLevelThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[kWarps - 1];
  __syncthreads();
  return before + incl - x;
}

template <int SIGMA, bool LAZY>
__global__ void __launch_bounds__(kLevelThreads) bvss_push_level_kernel(
    const uint32_t* __restrict__ F, long long n_fwords,
    const int32_t* __restrict__ vss_start, const int32_t* __restrict__ vss_end,
    int32_t n, const uint4* __restrict__ masks4,
    const int32_t* __restrict__ row_ids, int32_t lvl, int32_t* levels,
    uint8_t* marks) {
  __shared__ int s_warp[kLevelThreads / 32];
  __shared__ int32_t s_vert[kListCap];   // the round's frontier vertices
  __shared__ int32_t s_first[kListCap];  // each one's first VSS
  __shared__ int s_off[kListCap];        // each one's first pair
  __shared__ int s_slot[bvss::kHitBatch][kLevelThreads];  // queued hits
  const int tid = threadIdx.x;
  const long long wi = (long long)blockIdx.x * kLevelThreads + tid;
  const uint32_t word = wi < n_fwords ? __ldg(F + wi) : 0u;
  int set_total;
  const int rank0 = block_exclusive_sum(__popc(word), s_warp, &set_total);
  for (int round = 0; round < set_total; round += kListCap) {
    // this round's slice of the block's set bits, in vertex order
    uint32_t bits = word;
    for (int rank = rank0; bits && rank < round + kListCap; ++rank) {
      const long long v = wi * 32 + (__ffs(bits) - 1);
      bits &= bits - 1;
      if (rank >= round) s_vert[rank - round] = v < n ? (int32_t)v : n;
    }
    __syncthreads();
    const int m = min(kListCap, set_total - round);
    // VSS counts -> each vertex's first pair (vertex n's range is empty)
    int first[kPerThread], count[kPerThread], mine = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid * kPerThread + k;
      first[k] = count[k] = 0;
      if (i < m) {
        const int32_t v = s_vert[i];
        first[k] = __ldg(vss_start + v);
        count[k] = __ldg(vss_end + v) - first[k];
      }
      mine += count[k];
    }
    int pairs;
    int off = block_exclusive_sum(mine, s_warp, &pairs);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid * kPerThread + k;
      if (i < m) {
        s_first[i] = first[k];
        s_off[i] = off;
      }
      off += count[k];
    }
    __syncthreads();
    // one thread a pair: the last vertex whose first pair is <= p owns p
    for (int p = tid; p < pairs; p += kLevelThreads) {
      int lo = 0, hi = m;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= p) lo = mid; else hi = mid;
      }
      const int32_t v = s_vert[lo];
      bvss::push_pair<SIGMA, LAZY>(
          masks4, row_ids, (long long)s_first[lo] + (p - s_off[lo]),
          static_cast<uint32_t>(v & (SIGMA - 1)), lvl, levels, marks,
          &s_slot[0][tid], kLevelThreads);
    }
    __syncthreads();
  }
}

template <int SIGMA>
void launch_level(const void* F, long long n_fwords, const void* vss_start,
                  const void* vss_end, long long n, const void* masks,
                  const void* row_ids, int lvl, void* levels, void* marks,
                  cudaStream_t stream) {
  const long long blocks = (n_fwords + kLevelThreads - 1) / kLevelThreads;
  const auto* f = static_cast<const uint32_t*>(F);
  const auto* s = static_cast<const int32_t*>(vss_start);
  const auto* e = static_cast<const int32_t*>(vss_end);
  const auto* m = static_cast<const uint4*>(masks);
  const auto* rows = static_cast<const int32_t*>(row_ids);
  if (marks != nullptr) {
    bvss_push_level_kernel<SIGMA, true>
        <<<(unsigned)blocks, kLevelThreads, 0, stream>>>(
            f, n_fwords, s, e, (int32_t)n, m, rows, lvl, nullptr,
            static_cast<uint8_t*>(marks));
  } else {
    bvss_push_level_kernel<SIGMA, false>
        <<<(unsigned)blocks, kLevelThreads, 0, stream>>>(
            f, n_fwords, s, e, (int32_t)n, m, rows, lvl,
            static_cast<int32_t*>(levels), nullptr);
  }
}

}  // namespace

extern "C" int bvss_push_launch(const void* masks, const void* bits,
                                void* hits, long long B, int sigma,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: launch<1>(masks, bits, hits, B, s); break;
    case 2: launch<2>(masks, bits, hits, B, s); break;
    case 4: launch<4>(masks, bits, hits, B, s); break;
    case 8: launch<8>(masks, bits, hits, B, s); break;
    case 16: launch<16>(masks, bits, hits, B, s); break;
    case 32: launch<32>(masks, bits, hits, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// levels (N + 1,) int32 for the eager store, or marks (N + 1,) uint8 for the
// lazy one, indexed by row id only: N is n on one device and a shard's local
// row count on a mesh, where n stays the global vertex count of vss_start /
// vss_end.  Exactly one of the two is non-null.  masks must be 16-byte
// aligned (its rows are read as uint4) and n below 2^31 - 1.
extern "C" int bvss_push_level_launch(const void* F, long long n_fwords,
                                      const void* vss_start,
                                      const void* vss_end, long long n,
                                      const void* masks, const void* row_ids,
                                      int lvl, int sigma, void* levels,
                                      void* marks, void* stream) {
  if ((levels == nullptr) == (marks == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1:
      launch_level<1>(F, n_fwords, vss_start, vss_end, n, masks, row_ids,
                       lvl, levels, marks, st);
      break;
    case 2:
      launch_level<2>(F, n_fwords, vss_start, vss_end, n, masks, row_ids,
                       lvl, levels, marks, st);
      break;
    case 4:
      launch_level<4>(F, n_fwords, vss_start, vss_end, n, masks, row_ids,
                       lvl, levels, marks, st);
      break;
    case 8:
      launch_level<8>(F, n_fwords, vss_start, vss_end, n, masks, row_ids,
                       lvl, levels, marks, st);
      break;
    case 16:
      launch_level<16>(F, n_fwords, vss_start, vss_end, n, masks, row_ids,
                       lvl, levels, marks, st);
      break;
    case 32:
      launch_level<32>(F, n_fwords, vss_start, vss_end, n, masks, row_ids,
                       lvl, levels, marks, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvss_push_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
