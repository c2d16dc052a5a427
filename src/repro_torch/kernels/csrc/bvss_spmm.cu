// Batched BVSS bit-SpMM for Hopper (sm_90a): the multi-source pull of the
// wave engine.  For every queued VSS b, slice k = j*32 + l (mask bits
// sigma*j .. sigma*j + sigma-1 of word l) and stacked source column s:
//
//     y[b, j, l, s] = popc(slice(b, j, l) & fbytes[b, s] & smask)
//
// Replaces: repro/kernels/mxu_pull.py::bvss_spmm (_bvss_spmm_kernel), the
// Pallas kernel that unpacks the (tau, sigma) slice bits and the (sigma, S)
// frontier bits and contracts them on the TPU's matrix unit.
//
// Bound on an H100: memory, on the output.  Per VSS the kernel reads 128 B
// of mask words and 4*S B of frontier bytes and writes tau*S int32 counts:
// at sigma = 8, S = 8 that is 4,096 B written per 160 B read, so the
// 65,536-VSS narrow queue of grid2d(2048, 2048) writes 268 MB and reads
// 10.5 MB, 83.3 us at 3.35 TB/s.  The arithmetic (an AND and a popcount
// per count, 67M of each there) is a few microseconds of integer issue.
//
// Tensor cores are not used.  A b1 mma.sync.m8n8k128 ... .and.popc pads
// the sigma-bit contraction to k = 128 (15/16 of it wasted at sigma = 8),
// and it writes exactly the same int32 counts, whose bytes set the bound.
//
// Design: a warp per VSS.  A VSS's output is contiguous, so the warp writes
// it as 512-byte chunks: lane l stores the 16-byte quad l of each chunk,
// and every store instruction fills 16 whole 32-byte sectors (a thread per
// slice row would store 16-byte pieces at a 32-byte stride: half of every
// sector per instruction, twice the store requests).  A quad is four columns
// of one row k: with Q = S/4 a power of two up to 32 (S in {4, 8, ...,
// 128}), lane l always owns columns 4*(l % Q) .. +3 and row
// k = c*(32/Q) + l/Q of chunk c, so it loads its four frontier bytes once
// per VSS and needs no division.  The VSS's 32 mask words sit one per lane
// (one 128-byte load) and a lane fetches row k's word with __shfl_sync.
// The grid has a block per 8 VSSs.  On the H100 a persistent grid of
// resident blocks that loaded the next VSS's operands into registers
// during the current VSS's stores was slower than letting the block
// scheduler refill the SMs, and 2 or 4 VSSs a warp, 128- or 512-thread
// blocks and evict-first stores (__stcs) were no faster.  Any other S (not
// a multiple of 4, or Q not a power of two up to 32) takes the scalar
// path: 128-byte chunks, lane l the word l of each, row and column stepped
// without division; there, and for a frontier view that is not 16-byte
// aligned, frontier bytes are 4-byte loads.  Every launch returns
// cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Slice k of the VSS whose mask word l is in lane l's `mw`.
template <int SIGMA>
__device__ __forceinline__ uint32_t slice_of(uint32_t mw, unsigned k) {
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  return (__shfl_sync(kFull, mw, k & 31u) >> (SIGMA * (k >> 5))) & SMASK;
}

__device__ __forceinline__ uint4 load_quad(const uint32_t* p, int fvec) {
  if (fvec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// S = 4 << lq, lq in 0..5: a lane's column quad is fixed (see the note).
template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_quads(const uint32_t* __restrict__ masks,
                const uint32_t* __restrict__ fbytes, int4* __restrict__ out,
                long long B, int lq, int fvec) {
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
  const uint4 f = load_quad(fbytes + b * S + s0, fvec);
  int4* y = out + b * (long long)(chunks * 32u) + lane;
#pragma unroll 4
  for (unsigned c = 0; c < chunks; ++c) {
    const uint32_t sl = slice_of<SIGMA>(mw, c * rows_per_chunk + row0);
    y[c * 32u] = make_int4(__popc(sl & f.x), __popc(sl & f.y),
                           __popc(sl & f.z), __popc(sl & f.w));
  }
}

// Any S: element e = c*32 + lane of the VSS's output is row e / S, column
// e % S; both step by 32 per chunk without a division.
template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_scalar(const uint32_t* __restrict__ masks,
                 const uint32_t* __restrict__ fbytes,
                 int32_t* __restrict__ out, long long B, unsigned S) {
  constexpr unsigned SPW = 32 / SIGMA;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned chunks = SPW * S;               // 128-B chunks of one VSS
  const unsigned dk = 32u / S, ds = 32u % S;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                            // b is warp-uniform
  const uint32_t mw = __ldg(masks + b * 32 + lane);
  const uint32_t* fb = fbytes + b * S;
  int32_t* y = out + b * (long long)(chunks * 32u) + lane;
  unsigned k = lane / S, s = lane % S;
  for (unsigned c = 0; c < chunks; ++c) {
    y[c * 32u] = __popc(slice_of<SIGMA>(mw, k) & __ldg(fb + s));
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

template <int SIGMA>
void launch(const void* masks, const void* fbytes, void* out, long long B,
            int S, cudaStream_t stream) {
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const uint32_t* f = static_cast<const uint32_t*>(fbytes);
  int lq = -1;
  for (int q = 0; q <= 5; ++q)
    if (S == (4 << q)) lq = q;
  if (lq >= 0) {
    const int fvec = reinterpret_cast<uintptr_t>(fbytes) % 16 == 0;
    bvss_spmm_quads<SIGMA><<<grid_for(B), kThreads, 0, stream>>>(
        m, f, static_cast<int4*>(out), B, lq, fvec);
  } else {
    bvss_spmm_scalar<SIGMA><<<grid_for(B), kThreads, 0, stream>>>(
        m, f, static_cast<int32_t*>(out), B, (unsigned)S);
  }
}

}  // namespace

extern "C" int bvss_spmm_launch(const void* masks, const void* fbytes,
                                void* out, long long B, int S, int sigma,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (sigma) {
    case 1: launch<1>(masks, fbytes, out, B, S, s); break;
    case 2: launch<2>(masks, fbytes, out, B, S, s); break;
    case 4: launch<4>(masks, fbytes, out, B, S, s); break;
    case 8: launch<8>(masks, fbytes, out, B, S, s); break;
    case 16: launch<16>(masks, fbytes, out, B, S, s); break;
    case 32: launch<32>(masks, fbytes, out, B, S, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bvss_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
