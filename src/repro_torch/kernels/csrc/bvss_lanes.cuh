// The warp-per-VSS body shared by the BVSS pull and push kernels.
//
// One warp per VSS, lane l owns mask word l, so the warp's 32 mask loads are
// one coalesced 128-byte line.  The sigma-bit frontier byte is replicated
// 32/sigma times in a register; for each slot j the warp writes 32
// neighbouring hit bytes.  sigma is a template parameter so the slot loop
// unrolls.
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

}  // namespace bvss
