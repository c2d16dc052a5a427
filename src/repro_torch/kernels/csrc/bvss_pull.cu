// BVSS pull for Hopper (sm_90a): hits[b, j, l] = slice (j, l) of VSS b meets
// the sigma-bit frontier byte of its slice set.
//
// Replaces: repro/kernels/bvss_pull.py::bvss_pull (_pull_kernel_lanes and
// _pull_kernel_rows), the Pallas VPU kernel of the single-source pull.
//
// Bound on an H100: memory.  Per VSS the kernel must read 128 B of mask
// words and 4 B of frontier byte and write 32/sigma * 32 B of hits, with a
// handful of integer ops per word: at sigma = 8 that is 260 B per VSS, so a
// 524,288-VSS queue is ~136 MB, ~41 us at 3.35 TB/s.
//
// Design: the paper's own mapping, one warp per VSS (bvss_lanes.cuh); the
// frontier byte is one broadcast load per warp.  Every launch returns
// cudaGetLastError() to the caller.
#include "bvss_lanes.cuh"

namespace {

using bvss::kWarpsPerBlock;

template <int SIGMA>
__global__ void bvss_pull_kernel(const uint32_t* __restrict__ masks,
                                 const uint32_t* __restrict__ fbytes,
                                 uint8_t* __restrict__ hits, long long B) {
  const long long b =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  bvss::emit_hits<SIGMA>(masks, __ldg(fbytes + b), hits, b,
                         threadIdx.x & 31);
}

template <int SIGMA>
void launch(const void* masks, const void* fbytes, void* hits, long long B,
            cudaStream_t stream) {
  const long long blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bvss_pull_kernel<SIGMA><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                            stream>>>(
      static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(fbytes), static_cast<uint8_t*>(hits), B);
}

}  // namespace

extern "C" int bvss_pull_launch(const void* masks, const void* fbytes,
                                void* hits, long long B, int sigma,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: launch<1>(masks, fbytes, hits, B, s); break;
    case 2: launch<2>(masks, fbytes, hits, B, s); break;
    case 4: launch<4>(masks, fbytes, hits, B, s); break;
    case 8: launch<8>(masks, fbytes, hits, B, s); break;
    case 16: launch<16>(masks, fbytes, hits, B, s); break;
    case 32: launch<32>(masks, fbytes, hits, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvss_pull_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
