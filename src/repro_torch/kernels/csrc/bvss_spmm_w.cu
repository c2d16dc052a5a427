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
// sigma = 8, S = 8 that is 4,096 B written per 384 B read (rmat(18)'s
// 38,852 VSSs: 174.0 MB, 51.9 us at 3.35 TB/s); at S = 1, PageRank's
// shape, 512 B written per 160 B read (26.1 MB, 7.8 us).  The adds (at most
// sigma per output) are far below the f32 rate.
//
// Tensor cores are not used.  An MMA sums its products in an order of its
// own, and TF32 rounds the values, so neither would equal the ascending f32
// chain of the twin (kernels/ref.py::bvss_spmm_w_ref), which keeps sigma
// exact and PageRank convergent.
//
// Design: bvss_spmm.cu's layout, which writes the same (B, 32/sigma, 32, S)
// shape.  A warp per VSS, a block per 8 VSSs, the grid sized to the work
// with an early return, no shared memory and no barrier.  A VSS's output is
// contiguous, so the warp writes it in 512-byte chunks: lane l stores the
// 16-byte quad l of each chunk, and every store instruction fills 16 whole
// 32-byte sectors.  With Q = S/4 a power of two up to 32 (S in {4, 8, ...,
// 128}) lane l always owns columns 4*(l % Q) .. +3 and row c*(32/Q) + l/Q
// of chunk c, so its sigma quads of x load once per VSS (into registers
// for sigma <= 8; wider slices read them through L1 at each use).  At
// S = 1 lane l owns rows 4l .. 4l+3 of each chunk and stores them as one
// quad; the sigma values of x serve the whole VSS.  Any other S, or rows of
// x not 16-byte aligned, take the scalar path: 128-byte chunks, lane l the
// word l of each, row and column stepped without division.  The VSS's 32
// mask words sit one per lane (one 128-byte load) and a lane fetches row
// k's word with __shfl_sync.  Each output adds the values of its set bits
// in ascending i, every product being {0,1} * x, so the sum is the twin's
// bit for bit.  The slice mask is a constexpr per sigma: (1u << 32) - 1 is
// undefined.  Every launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Slice j of mask word l of the VSS whose word l is in lane l's `mw`.
template <int SIGMA>
__device__ __forceinline__ uint32_t slice_at(uint32_t mw, unsigned l,
                                             unsigned j) {
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  return (__shfl_sync(kFull, mw, l) >> (SIGMA * j)) & SMASK;
}

// Slice k = j*32 + l.
template <int SIGMA>
__device__ __forceinline__ uint32_t slice_of(uint32_t mw, unsigned k) {
  return slice_at<SIGMA>(mw, k & 31u, k >> 5);
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// S = 4 << lq, lq in 0..5: a lane's column quad is fixed (see the note).
template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_w_quads(const uint32_t* __restrict__ masks,
                  const float* __restrict__ xvals, float4* __restrict__ out,
                  long long B, int lq) {
  constexpr unsigned SPW = 32 / SIGMA;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned S = 4u << lq;
  const unsigned chunks = SPW << lq;             // 512-B chunks of one VSS
  const unsigned rows_per_chunk = 32u >> lq;
  const unsigned row0 = lane >> lq;
  const unsigned s0 = (lane & ((1u << lq) - 1u)) * 4u;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                            // b is warp-uniform
  const uint32_t mw = __ldg(masks + b * 32 + lane);
  const float4* xb =
      reinterpret_cast<const float4*>(xvals + b * SIGMA * (long long)S + s0);
  const unsigned xstep = S / 4;                  // quads from row i to i+1
  float4* y = out + b * (long long)(chunks * 32u) + lane;
  if constexpr (SIGMA <= 8) {
    float4 x[SIGMA];
#pragma unroll
    for (int i = 0; i < SIGMA; ++i) x[i] = __ldg(xb + i * xstep);
#pragma unroll 4
    for (unsigned c = 0; c < chunks; ++c) {
      const uint32_t sl = slice_of<SIGMA>(mw, c * rows_per_chunk + row0);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < SIGMA; ++i)
        if ((sl >> i) & 1u) add4(acc, x[i]);
      y[c * 32u] = acc;
    }
  } else {
    for (unsigned c = 0; c < chunks; ++c) {
      const uint32_t sl = slice_of<SIGMA>(mw, c * rows_per_chunk + row0);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < SIGMA; ++i)
        if ((sl >> i) & 1u) add4(acc, __ldg(xb + i * xstep));
      y[c * 32u] = acc;
    }
  }
}

// S = 1: lane l owns rows 4l .. 4l+3 of each 128-row chunk.
template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_w_rows(const uint32_t* __restrict__ masks,
                 const float* __restrict__ xvals, float4* __restrict__ out,
                 long long B) {
  constexpr unsigned SPW = 32 / SIGMA;
  constexpr unsigned TAU = 32 * SPW;
  constexpr unsigned CHUNKS = (TAU + 127) / 128;  // sigma 16, 32: part of one
  const unsigned lane = threadIdx.x & 31u;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                            // b is warp-uniform
  const uint32_t mw = __ldg(masks + b * 32 + lane);
  float x[SIGMA];
#pragma unroll
  for (int i = 0; i < SIGMA; ++i) x[i] = __ldg(xvals + b * SIGMA + i);
  float4* y = out + b * (long long)(TAU / 4) + lane;
#pragma unroll
  for (unsigned c = 0; c < CHUNKS; ++c) {
    // rows k = 128c + 4*lane + q share j = k >> 5 (4*lane + q < 128), given
    // here without the row: nvcc 12.8 shifted by k itself when it derived
    // j from k for this loop at sigma = 1; rows past tau (sigma 16, 32)
    // read a harmless slice and store nothing
    const unsigned j = (4u * c + (lane >> 3)) & (SPW - 1u);
    float r[4];
#pragma unroll
    for (unsigned q = 0; q < 4; ++q) {
      const uint32_t sl = slice_at<SIGMA>(mw, (4u * lane + q) & 31u, j);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SIGMA; ++i)
        if ((sl >> i) & 1u) acc += x[i];
      r[q] = acc;
    }
    if (c * 128u + 4u * lane < TAU)
      y[c * 32u] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// Any S: element e = c*32 + lane of the VSS's output is row e / S, column
// e % S; both step by 32 per chunk without a division.
template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_w_scalar(const uint32_t* __restrict__ masks,
                   const float* __restrict__ xvals, float* __restrict__ out,
                   long long B, unsigned S) {
  constexpr unsigned SPW = 32 / SIGMA;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned chunks = SPW * S;               // 128-B chunks of one VSS
  const unsigned dk = 32u / S, ds = 32u % S;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                            // b is warp-uniform
  const uint32_t mw = __ldg(masks + b * 32 + lane);
  const float* xb = xvals + b * SIGMA * (long long)S;
  float* y = out + b * (long long)(chunks * 32u) + lane;
  unsigned k = lane / S, s = lane % S;
  for (unsigned c = 0; c < chunks; ++c) {
    const uint32_t sl = slice_of<SIGMA>(mw, k);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < SIGMA; ++i)
      if ((sl >> i) & 1u) acc += __ldg(xb + i * S + s);
    y[c * 32u] = acc;
    k += dk;
    s += ds;
    if (s >= S) {
      s -= S;
      ++k;
    }
  }
}

// A warp per VSS.
unsigned grid_for(long long B) { return (unsigned)((B + kWarps - 1) / kWarps); }

// 16-byte x loads and output stores need S % 4 == 0 and x 16-byte aligned;
// the output is the wrapper's own allocation, which always is.
template <int SIGMA>
void launch(const void* masks, const void* xvals, void* out, long long B,
            int S, cudaStream_t stream) {
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const float* x = static_cast<const float*>(xvals);
  const int vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int lq = -1;
  for (int q = 0; q <= 5; ++q)
    if (S == (4 << q)) lq = q;
  if (S == 1) {
    bvss_spmm_w_rows<SIGMA><<<grid_for(B), kThreads, 0, stream>>>(
        m, x, static_cast<float4*>(out), B);
  } else if (vec && lq >= 0) {
    bvss_spmm_w_quads<SIGMA><<<grid_for(B), kThreads, 0, stream>>>(
        m, x, static_cast<float4*>(out), B, lq);
  } else {
    bvss_spmm_w_scalar<SIGMA><<<grid_for(B), kThreads, 0, stream>>>(
        m, x, static_cast<float*>(out), B, (unsigned)S);
  }
}

}  // namespace

extern "C" int bvss_spmm_w_launch(const void* masks, const void* xvals,
                                  void* out, long long B, int S, int sigma,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (sigma) {
    case 1: launch<1>(masks, xvals, out, B, S, s); break;
    case 2: launch<2>(masks, xvals, out, B, S, s); break;
    case 4: launch<4>(masks, xvals, out, B, S, s); break;
    case 8: launch<8>(masks, xvals, out, B, S, s); break;
    case 16: launch<16>(masks, xvals, out, B, S, s); break;
    case 32: launch<32>(masks, xvals, out, B, S, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvss_spmm_w_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
