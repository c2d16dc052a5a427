// Tropical (min, +) BVSS pull for Hopper (sm_90a): the SSSP relaxation.
// For every queued VSS b, slice k = j*32 + l (mask bits sigma*j ..
// sigma*j + sigma-1 of word l) and stacked distance column s:
//
//     y[b, k, s] = min over set bits i of slice(b, k) of (w[b, k, i] + x[b, i, s])
//
// and +inf where the slice has no bit set.
//
// Replaces: repro/kernels/mxu_pull.py::bvss_spmm_minplus
// (_bvss_spmm_minplus_kernel via _spmm_minplus_call), the Pallas kernel
// that unrolls the sigma-wide min over a (tau, sigma) weight tile and a
// (sigma, S) distance tile in the TPU's vector unit.
//
// Bound on an H100: memory.  Per VSS the kernel reads 128 B of mask words,
// the 4*tau*sigma B weight-plane rows and 4*sigma*S B of distances, and
// writes 4*tau*S B: at sigma = 8, S = 8, 8,448 B read and 4,096 B written.
// The adds and mins (at most sigma per output) are far below the f32 rate.
//
// Design: one block per VSS, one thread per slice row k (tau threads).  The
// block stages the VSS's (sigma, S) distance block in shared memory; each
// thread extracts its sigma-bit slice and keeps its row's sigma weights in
// registers, then takes fminf over the set bits only.  Every add and min is
// exactly rounded and no NaN can form (no -inf enters: weights are
// positive, distances are >= 0 or +inf), so the result equals the twin
// (kernels/ref.py::bvss_spmm_minplus_ref) and the TPU kernel exactly.  A
// thread's S outputs are contiguous: 16-byte stores when S % 4 == 0.
// Every launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int SIGMA>
__global__ void __launch_bounds__(32 * (32 / SIGMA))
bvss_spmm_minplus_kernel(const uint32_t* __restrict__ masks,
                         const float* __restrict__ wvals,
                         const float* __restrict__ xvals,
                         float* __restrict__ out, int S, int vec) {
  constexpr int SPW = 32 / SIGMA;
  constexpr int TAU = 32 * SPW;
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  extern __shared__ float xs[];                 // (SIGMA, S) of this VSS
  const long long b = blockIdx.x;
  const int k = threadIdx.x;
  const float* xb = xvals + b * SIGMA * (long long)S;
  for (int e = k; e < SIGMA * S; e += TAU) xs[e] = __ldg(xb + e);
  const uint32_t slice =
      (__ldg(masks + b * 32 + (k & 31)) >> (SIGMA * (k >> 5))) & SMASK;
  const float* wrow = wvals + (b * TAU + k) * SIGMA;
  float w[SIGMA];
#pragma unroll
  for (int i = 0; i < SIGMA; ++i) w[i] = __ldg(wrow + i);
  __syncthreads();
  const float inf = __int_as_float(0x7f800000);
  float* y = out + (b * TAU + k) * (long long)S;
  if (vec) {  // S % 4 == 0: out is the wrapper's own, so rows align
    for (int s = 0; s < S; s += 4) {
      float4 acc = make_float4(inf, inf, inf, inf);
#pragma unroll
      for (int i = 0; i < SIGMA; ++i) {
        if ((slice >> i) & 1u) {
          const float* xi = xs + i * S + s;
          acc.x = fminf(acc.x, w[i] + xi[0]);
          acc.y = fminf(acc.y, w[i] + xi[1]);
          acc.z = fminf(acc.z, w[i] + xi[2]);
          acc.w = fminf(acc.w, w[i] + xi[3]);
        }
      }
      *reinterpret_cast<float4*>(y + s) = acc;
    }
  } else {
    for (int s = 0; s < S; ++s) {
      float acc = inf;
#pragma unroll
      for (int i = 0; i < SIGMA; ++i)
        if ((slice >> i) & 1u) acc = fminf(acc, w[i] + xs[i * S + s]);
      y[s] = acc;
    }
  }
}

template <int SIGMA>
int launch(const void* masks, const void* wvals, const void* xvals,
           void* out, long long B, int S, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SIGMA * (size_t)S;
  bvss_spmm_minplus_kernel<SIGMA><<<(unsigned)B, 32 * (32 / SIGMA), smem,
                                    stream>>>(
      static_cast<const uint32_t*>(masks), static_cast<const float*>(wvals),
      static_cast<const float*>(xvals), static_cast<float*>(out), S, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvss_spmm_minplus_launch(const void* masks, const void* wvals,
                                        const void* xvals, void* out,
                                        long long B, int S, int sigma,
                                        int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: return launch<1>(masks, wvals, xvals, out, B, S, vec, s);
    case 2: return launch<2>(masks, wvals, xvals, out, B, S, vec, s);
    case 4: return launch<4>(masks, wvals, xvals, out, B, S, vec, s);
    case 8: return launch<8>(masks, wvals, xvals, out, B, S, vec, s);
    case 16: return launch<16>(masks, wvals, xvals, out, B, S, vec, s);
    case 32: return launch<32>(masks, wvals, xvals, out, B, S, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bvss_spmm_minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
