// BVSS push for Hopper (sm_90a): the pull against a one-hot frontier byte.
// Each queued entry b is one (frontier vertex, VSS) pair; the frontier byte
// is 1 << bits[b], the vertex's bit inside its own slice set.
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

extern "C" const char* bvss_push_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
