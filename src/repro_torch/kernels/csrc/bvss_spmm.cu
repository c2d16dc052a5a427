// Batched BVSS bit-SpMM for Hopper (sm_90a): the multi-source pull of the
// wave engine.  For every queued VSS b, slice k = j*32 + l (mask bits
// sigma*j .. sigma*j + sigma-1 of word l) and stacked source column s:
//
//     y[b, j, l, s] = popc(slice(b, j, l) & fbytes[b, s] & smask)
//
// Replaces: repro/kernels/mxu_pull.py::bvss_spmm (_bvss_spmm_kernel), the
// Pallas kernel that unpacks the (tau, sigma) slice bits and the (sigma, S)
// frontier bits and contracts them on the TPU's matrix unit.  The AND and
// __popc here are what a b1 mma.sync ... .and.popc computes per entry; the
// tensor-core form is later work.
//
// Bound on an H100: memory, on the output.  Per VSS the kernel reads 128 B
// of mask words and 4*S B of frontier bytes and writes tau*S int32 counts:
// at sigma = 8, S = 8 that is 4,096 B written per 160 B read, so the
// 65,536-VSS narrow queue of grid2d(2048, 2048) moves ~279 MB, ~83 us at
// 3.35 TB/s.  The arithmetic (an AND and a popcount per count) is far
// below the integer rate.
//
// Design: one thread per slice row r = b*tau + k.  It extracts its sigma-bit
// slice once (a warp's 32 rows share one slot j, so the warp's mask loads
// are one 128-byte line) and writes its S counts, which are contiguous in
// the output, as 16-byte stores when S is a multiple of 4; the frontier
// bytes of its VSS are a broadcast load within the warp.  No index division
// by the runtime S is needed.  Every launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_kernel(const uint32_t* __restrict__ masks,
                 const uint32_t* __restrict__ fbytes,
                 int32_t* __restrict__ out, unsigned long long rows, int S,
                 int vec) {
  constexpr int SPW = 32 / SIGMA;
  constexpr unsigned TAU = 32u * SPW;
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  const unsigned long long r =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const unsigned long long b = r / TAU;
  const unsigned k = (unsigned)(r % TAU);
  const unsigned j = k >> 5, l = k & 31u;
  const uint32_t slice = (__ldg(masks + b * 32 + l) >> (SIGMA * j)) & SMASK;
  const uint32_t* fb = fbytes + b * (unsigned long long)S;
  int32_t* y = out + r * (unsigned long long)S;
  if (vec) {  // S % 4 == 0 and 16-byte aligned rows (checked by the wrapper)
    for (int s = 0; s < S; s += 4) {
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(fb + s));
      int4 v;
      v.x = __popc(slice & f.x);
      v.y = __popc(slice & f.y);
      v.z = __popc(slice & f.z);
      v.w = __popc(slice & f.w);
      *reinterpret_cast<int4*>(y + s) = v;
    }
  } else {
    for (int s = 0; s < S; ++s) y[s] = __popc(slice & __ldg(fb + s));
  }
}

template <int SIGMA>
void launch(const void* masks, const void* fbytes, void* out, long long B,
            int S, int vec, cudaStream_t stream) {
  constexpr long long TAU = 32LL * (32 / SIGMA);
  const unsigned long long rows = (unsigned long long)(B * TAU);
  const unsigned long long blocks = (rows + kThreads - 1) / kThreads;
  bvss_spmm_kernel<SIGMA><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(fbytes), static_cast<int32_t*>(out), rows,
      S, vec);
}

}  // namespace

extern "C" int bvss_spmm_launch(const void* masks, const void* fbytes,
                                void* out, long long B, int S, int sigma,
                                int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: launch<1>(masks, fbytes, out, B, S, vec, s); break;
    case 2: launch<2>(masks, fbytes, out, B, S, vec, s); break;
    case 4: launch<4>(masks, fbytes, out, B, S, vec, s); break;
    case 8: launch<8>(masks, fbytes, out, B, S, vec, s); break;
    case 16: launch<16>(masks, fbytes, out, B, S, vec, s); break;
    case 32: launch<32>(masks, fbytes, out, B, S, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvss_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
