// Transposed weighted BVSS product for Hopper (sm_90a): the Brandes backward
// dependency sweep.  For every queued VSS b, slice-set column i and stacked
// column s:
//
//     y[b, i, s] = sum over slices k = j*32 + l, ascending, whose bit i is
//                  set (bit sigma*j + i of mask word l), of h[b, k, s]
//
// Replaces: repro/kernels/mxu_pull.py::bvss_spmm_t (_bvss_spmm_t_kernel via
// _spmm_float_call), the Pallas kernel that contracts the unpacked
// (tau, sigma) tile with the (tau, S) row values along the row axis on the
// TPU's matrix unit.
//
// Bound on an H100: memory, on the input.  Per VSS the kernel reads 128 B
// of mask words and 4*tau*S B of row values and writes 4*sigma*S B: at
// sigma = 8, S = 8 that is 4,224 B read per 256 B written.  The adds (at
// most tau per output) are far below the f32 rate.
//
// Design: one thread per output (b, i, s), 256 to a block; neighbouring
// threads take neighbouring s, then i, so a warp's output is contiguous.
// A thread keeps its VSS's 32 mask words in registers and walks the tau
// rows in ascending k, loading h[b, k, s] only where bit i is set.  The
// sigma threads of one (b, s) read the same row values, so each value
// comes from device memory once and from L1 after.  The order of the adds
// is the twin's (kernels/ref.py::bvss_spmm_t_ref), so the two are equal
// bit for bit.  Every launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_t_kernel(const uint32_t* __restrict__ masks,
                   const float* __restrict__ hvals, float* __restrict__ out,
                   unsigned long long outputs, int S) {
  constexpr int SPW = 32 / SIGMA;
  constexpr int TAU = 32 * SPW;
  const unsigned long long r =
      (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= outputs) return;
  const unsigned long long per_vss = (unsigned long long)SIGMA * S;
  const unsigned long long b = r / per_vss;
  const int rem = (int)(r % per_vss);
  const int i = rem / S;
  const int s = rem % S;
  uint32_t w[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) w[l] = __ldg(masks + b * 32 + l);
  const float* h = hvals + b * TAU * (unsigned long long)S + s;
  float acc = 0.f;
  for (int j = 0; j < SPW; ++j) {
    const int shift = SIGMA * j + i;
#pragma unroll
    for (int l = 0; l < 32; ++l)
      if ((w[l] >> shift) & 1u) acc += __ldg(h + (j * 32 + l) * (long long)S);
  }
  out[r] = acc;
}

template <int SIGMA>
int launch(const void* masks, const void* hvals, void* out, long long B,
           int S, cudaStream_t stream) {
  const unsigned long long outputs = (unsigned long long)B * SIGMA * S;
  const unsigned long long blocks = (outputs + kThreads - 1) / kThreads;
  bvss_spmm_t_kernel<SIGMA><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(masks), static_cast<const float*>(hvals),
      static_cast<float*>(out), outputs, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvss_spmm_t_launch(const void* masks, const void* hvals,
                                  void* out, long long B, int S, int sigma,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: return launch<1>(masks, hvals, out, B, S, s);
    case 2: return launch<2>(masks, hvals, out, B, S, s);
    case 4: return launch<4>(masks, hvals, out, B, S, s);
    case 8: return launch<8>(masks, hvals, out, B, S, s);
    case 16: return launch<16>(masks, hvals, out, B, S, s);
    case 32: return launch<32>(masks, hvals, out, B, S, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bvss_spmm_t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
