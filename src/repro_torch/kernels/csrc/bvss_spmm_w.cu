// Weighted BVSS pull for Hopper (sm_90a): the float channel of the wave
// engine (Brandes sigma path counts) and the PageRank matvec.  For every
// queued VSS b, slice k = j*32 + l (mask bits sigma*j .. sigma*j + sigma-1
// of word l) and stacked column s:
//
//     y[b, k, s] = sum over set bits i of slice(b, k), ascending, of x[b, i, s]
//
// Replaces: repro/kernels/mxu_pull.py::bvss_spmm_w (_bvss_spmm_w_kernel via
// _spmm_float_call), the Pallas kernel that unpacks the (tau, sigma) slice
// bits to a float tile and contracts it with the (sigma, S) column values on
// the TPU's matrix unit.
//
// Bound on an H100: memory, on the output.  Per VSS the kernel reads 128 B
// of mask words and 4*sigma*S B of values and writes 4*tau*S B: at
// sigma = 8, S = 8 that is 4,096 B written per 384 B read.  The adds (at
// most sigma per output) are far below the f32 rate.
//
// Design: one block per VSS, one thread per slice row k (tau threads).  The
// block stages its VSS's (sigma, S) value block in shared memory, then each
// thread extracts its sigma-bit slice once and, for each column s, adds the
// selected values in ascending i.  Every product is {0,1} * x, so the sum
// is the twin's (kernels/ref.py::bvss_spmm_w_ref) bit for bit.  A thread's
// S outputs are contiguous: 16-byte stores when S % 4 == 0, scalar stores
// otherwise (S = 1 is PageRank).  The slice mask is a constexpr per sigma:
// (1u << 32) - 1 is undefined.  Every launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int SIGMA>
__global__ void __launch_bounds__(32 * (32 / SIGMA))
bvss_spmm_w_kernel(const uint32_t* __restrict__ masks,
                   const float* __restrict__ xvals, float* __restrict__ out,
                   int S, int vec) {
  constexpr int SPW = 32 / SIGMA;
  constexpr int TAU = 32 * SPW;
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  extern __shared__ float xs[];                 // (SIGMA, S) of this VSS
  const long long b = blockIdx.x;
  const int k = threadIdx.x;
  const float* xb = xvals + b * SIGMA * (long long)S;
  for (int e = k; e < SIGMA * S; e += TAU) xs[e] = __ldg(xb + e);
  __syncthreads();
  const uint32_t slice =
      (__ldg(masks + b * 32 + (k & 31)) >> (SIGMA * (k >> 5))) & SMASK;
  float* y = out + (b * TAU + k) * (long long)S;
  if (vec) {  // S % 4 == 0 and 16-byte aligned rows (checked by the wrapper)
    for (int s = 0; s < S; s += 4) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < SIGMA; ++i) {
        if ((slice >> i) & 1u) {
          const float* xi = xs + i * S + s;
          acc.x += xi[0];
          acc.y += xi[1];
          acc.z += xi[2];
          acc.w += xi[3];
        }
      }
      *reinterpret_cast<float4*>(y + s) = acc;
    }
  } else {
    for (int s = 0; s < S; ++s) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SIGMA; ++i)
        if ((slice >> i) & 1u) acc += xs[i * S + s];
      y[s] = acc;
    }
  }
}

template <int SIGMA>
int launch(const void* masks, const void* xvals, void* out, long long B,
           int S, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SIGMA * (size_t)S;
  bvss_spmm_w_kernel<SIGMA><<<(unsigned)B, 32 * (32 / SIGMA), smem,
                              stream>>>(
      static_cast<const uint32_t*>(masks), static_cast<const float*>(xvals),
      static_cast<float*>(out), S, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvss_spmm_w_launch(const void* masks, const void* xvals,
                                  void* out, long long B, int S, int sigma,
                                  int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: return launch<1>(masks, xvals, out, B, S, vec, s);
    case 2: return launch<2>(masks, xvals, out, B, S, vec, s);
    case 4: return launch<4>(masks, xvals, out, B, S, vec, s);
    case 8: return launch<8>(masks, xvals, out, B, S, vec, s);
    case 16: return launch<16>(masks, xvals, out, B, S, vec, s);
    case 32: return launch<32>(masks, xvals, out, B, S, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bvss_spmm_w_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
