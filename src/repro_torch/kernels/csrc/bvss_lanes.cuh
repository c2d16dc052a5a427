// The bodies shared by the BVSS pull and push kernels.
//
// emit_hits: one warp per VSS, lane l owns mask word l, so the warp's 32
// mask loads are one coalesced 128-byte line.  The sigma-bit frontier byte
// is replicated 32/sigma times in a register; for each slot j the warp
// writes 32 neighbouring hit bytes.  sigma is a template parameter so the
// slot loop unrolls.
//
// push_pair / store_hits: the push level's body and its store epilogue, one
// thread per (frontier vertex, VSS) pair (bvss_push.cu says why).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace bvss {

constexpr int kWarpsPerBlock = 8;

// hits[b, j, lane] = slot j of mask word `lane` of VSS b meets byte fb.
template <int SIGMA>
__device__ __forceinline__ void emit_hits(const uint32_t* __restrict__ masks,
                                          uint32_t fb,
                                          uint8_t* __restrict__ hits,
                                          long long b, int lane) {
  constexpr int SPW = 32 / SIGMA;
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  fb &= SMASK;
  uint32_t fword = 0;
#pragma unroll
  for (int j = 0; j < SPW; ++j) fword |= fb << (SIGMA * j);
  const uint32_t anded = __ldg(masks + b * 32 + lane) & fword;
  uint8_t* out = hits + b * (SPW * 32) + lane;
#pragma unroll
  for (int j = 0; j < SPW; ++j)
    out[j * 32] = ((anded >> (SIGMA * j)) & SMASK) != 0u;
}

// Hit slots a push_pair thread resolves together (see push_pair).
constexpr int kHitBatch = 8;

// The push level's store epilogue: `count` hit slots of one VSS, resolved
// together.  slot[k * stride] is the offset of hit k inside the VSS's row
// ids.  All their row ids are loaded, then (eager) all their levels, then
// the stores made, so a batch waits on one memory latency a step, not one
// a hit.  Eager (LAZY false): store lvl where the row's level is still
// above it.  Lazy: store 1 into the row's mark.
//
// Plain stores, no atomics.  Every writer of a row in one launch stores the
// same value (lvl, or 1), so the order of racing stores does not matter,
// and a racing reader that already sees lvl skips a store that would write
// lvl anyway: the result is the unfused scatter's index_fill_ of the same
// rows.  levels is read with a plain load, not __ldg: this launch writes it.
template <bool LAZY>
__device__ __forceinline__ void store_hits(const int32_t* __restrict__ rows,
                                           const int* slot, int stride,
                                           int count, int32_t lvl,
                                           int32_t* levels, uint8_t* marks) {
  int32_t row[kHitBatch];
#pragma unroll
  for (int k = 0; k < kHitBatch; ++k)
    if (k < count) row[k] = __ldg(rows + slot[k * stride]);
  if (LAZY) {
#pragma unroll
    for (int k = 0; k < kHitBatch; ++k)
      if (k < count) marks[row[k]] = 1;
    return;
  }
  int32_t level[kHitBatch];
#pragma unroll
  for (int k = 0; k < kHitBatch; ++k)
    if (k < count) level[k] = levels[row[k]];
#pragma unroll
  for (int k = 0; k < kHitBatch; ++k)
    if (k < count && level[k] > lvl) levels[row[k]] = lvl;
}

// One (frontier vertex, VSS r) pair of a push level, by one thread: the
// vertex's bit `bit` = v % sigma inside its slice set is the one-hot byte,
// so slot j of word l is a hit iff bit sigma*j + bit of mask word l is set,
// on row row_ids[r, j, l].  The thread loads r's 128 bytes of mask as eight
// 16-byte loads, all issued before the first test; for each slot j it
// gathers that bit of the 32 words into one word of lanes, walks its set
// bits with __ffs, and queues the hits' slots in shared memory
// (slot[k * stride]) to resolve them kHitBatch at a time (store_hits).
// The slot loop is not unrolled: the kernel stays a few hundred
// instructions, which a cold instruction cache fetches quickly.
template <int SIGMA, bool LAZY>
__device__ __forceinline__ void push_pair(const uint4* __restrict__ masks4,
                                          const int32_t* __restrict__ row_ids,
                                          long long r, uint32_t bit,
                                          int32_t lvl, int32_t* levels,
                                          uint8_t* marks, int* slot,
                                          int stride) {
  constexpr int SPW = 32 / SIGMA;
  uint32_t w[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 m = __ldg(masks4 + r * 8 + q);
    w[4 * q] = m.x;
    w[4 * q + 1] = m.y;
    w[4 * q + 2] = m.z;
    w[4 * q + 3] = m.w;
  }
  const int32_t* rows = row_ids + r * (SPW * 32);
  int queued = 0;
#pragma unroll 1
  for (int j = 0; j < SPW; ++j) {
    const uint32_t shift = SIGMA * j + bit;
    uint32_t lanes = 0;
#pragma unroll
    for (int l = 0; l < 32; ++l) lanes |= ((w[l] >> shift) & 1u) << l;
    while (lanes) {
      slot[queued * stride] = j * 32 + __ffs(lanes) - 1;
      lanes &= lanes - 1;
      if (++queued == kHitBatch) {
        store_hits<LAZY>(rows, slot, stride, kHitBatch, lvl, levels, marks);
        queued = 0;
      }
    }
  }
  store_hits<LAZY>(rows, slot, stride, queued, lvl, levels, marks);
}

}  // namespace bvss
