// Batched BVSS bit-SpMM for Hopper (sm_90a): the multi-source pull of the
// wave engine, in two epilogues.  For every queued VSS b, slice
// k = j*32 + l (mask bits sigma*j .. sigma*j + sigma-1 of word l) and
// stacked source column s:
//
//     y[b, j, l, s] = popc(slice(b, j, l) & fbytes[b, s] & smask)
//
// The count epilogue (bvss_spmm_launch) writes y.  The mark epilogue
// (bvss_spmm_mark_launch) writes no count: it stores
// marks[row_ids[b, j, l], s] = 1 wherever y > 0, and nothing on a miss.
//
// Replaces: repro/kernels/mxu_pull.py::bvss_spmm (_bvss_spmm_kernel), the
// Pallas kernel that unpacks the (tau, sigma) slice bits and the (sigma, S)
// frontier bits and contracts them on the TPU's matrix unit.  The mark
// epilogue also replaces the eager scatter-min that the reference runs on
// those counts beside it (repro/core/multi_source.py:258, the level
// update of the kernel at mxu_pull.py:156), in the port's lazy form: a
// uint8 mark per hit (row, column) cell, which finalize turns into levels.
//
// Bound on an H100: memory.  Counts: per VSS the kernel reads 128 B of
// mask words and 4*S B of frontier bytes and writes tau*S int32 counts: at
// sigma = 8, S = 8 that is 4,096 B written per 160 B read, so the
// 65,536-VSS narrow queue of grid2d(2048, 2048) writes 268 MB and reads
// 10.5 MB, 83.3 us at 3.35 TB/s.  Marks: at the rgg_n_2_20 wave's full
// width (131,072 VSSs, sigma = 8, S = 64) it reads at most 16.8 MB of
// masks, 33.6 MB of frontier bytes and the live VSSs' 512 B of row ids
// each (20.1 MB at 30% live), and stores one byte per hit (a few MB):
// about 21 us at 3.35 TB/s, where the count form writes 4.29 GB (1.28 ms)
// for a separate scatter to read.  The arithmetic (an AND and a popcount per
// cell) is a few microseconds of integer issue.
//
// Tensor cores are not used.  A b1 mma.sync.m8n8k128 ... .and.popc pads
// the sigma-bit contraction to k = 128 (15/16 of it wasted at sigma = 8),
// and it writes exactly the same int32 counts, whose bytes set the bound.
//
// Design: a warp per VSS.  A VSS's output is contiguous, so the count
// warp writes it as 512-byte chunks: lane l stores the 16-byte quad l of
// each chunk, and every store instruction fills 16 whole 32-byte sectors
// (a thread per slice row would store 16-byte pieces at a 32-byte stride:
// half of every sector per instruction, twice the store requests).  A quad
// is four columns of one row k: with Q = S/4 a power of two up to 32
// (S in {4, 8, ..., 128}), lane l always owns columns 4*(l % Q) .. +3 and
// row k = c*(32/Q) + l/Q of chunk c, so it loads its four frontier bytes
// once per VSS and needs no division.  The VSS's 32 mask words sit one per
// lane (one 128-byte load) and a lane fetches row k's word with
// __shfl_sync.  The grid has a block per 8 VSSs.  On the H100 a persistent
// grid of resident blocks that loaded the next VSS's operands into
// registers during the current VSS's stores was slower than letting the
// block scheduler refill the SMs, and 2 or 4 VSSs a warp, 128- or
// 512-thread blocks and evict-first stores (__stcs) were no faster.  Any
// other S (not a multiple of 4, or Q not a power of two up to 32) takes
// the scalar path: 128-byte chunks, lane l the word l of each, row and
// column stepped without division; there, and for a frontier view that is
// not 16-byte aligned, frontier bytes are 4-byte loads.
//
// The mark epilogue walks the same cells in the same order.  A warp whose
// 32 mask words are all zero (the dummy VSSs that pad the queue to its
// launched width) returns after its one 128-byte load.  A lane with a hit
// in row k loads row_ids[b, k] (the lanes of one row load the same 4
// bytes, which the load unit merges) and stores one byte per hit column.
// Every writer of a mark stores the same value 1, so the racing stores of
// VSSs that share a row need no atomics, and no neighbouring column is
// read or rewritten.  Every launch returns cudaGetLastError().
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
// MARK false: out is the (B, 32/sigma, 32, S) int32 counts and rows is
// unused.  MARK true: out is the (L+1, S) uint8 marks and rows the
// (B, 32/sigma, 32) int32 row ids.
template <int SIGMA, bool MARK>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_quads(const uint32_t* __restrict__ masks,
                const uint32_t* __restrict__ fbytes, void* __restrict__ out,
                const int32_t* __restrict__ rows, long long B, int lq,
                int fvec) {
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
  if (MARK && !__any_sync(kFull, mw != 0u)) return;  // a dummy VSS
  const uint4 f = load_quad(fbytes + b * S + s0, fvec);
  if (MARK) {
    uint8_t* marks = static_cast<uint8_t*>(out) + s0;
    const int32_t* rid = rows + b * (SPW * 32u);
#pragma unroll 4
    for (unsigned c = 0; c < chunks; ++c) {
      const unsigned k = c * rows_per_chunk + row0;
      const uint32_t sl = slice_of<SIGMA>(mw, k);
      const bool h0 = sl & f.x, h1 = sl & f.y, h2 = sl & f.z, h3 = sl & f.w;
      if (h0 | h1 | h2 | h3) {
        uint8_t* m = marks + (long long)__ldg(rid + k) * S;
        if (h0) m[0] = 1;
        if (h1) m[1] = 1;
        if (h2) m[2] = 1;
        if (h3) m[3] = 1;
      }
    }
    return;
  }
  int4* y = static_cast<int4*>(out) + b * (long long)(chunks * 32u) + lane;
#pragma unroll 4
  for (unsigned c = 0; c < chunks; ++c) {
    const uint32_t sl = slice_of<SIGMA>(mw, c * rows_per_chunk + row0);
    y[c * 32u] = make_int4(__popc(sl & f.x), __popc(sl & f.y),
                           __popc(sl & f.z), __popc(sl & f.w));
  }
}

// Any S: element e = c*32 + lane of the VSS's output is row e / S, column
// e % S; both step by 32 per chunk without a division.  out and rows as in
// bvss_spmm_quads.
template <int SIGMA, bool MARK>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_scalar(const uint32_t* __restrict__ masks,
                 const uint32_t* __restrict__ fbytes, void* __restrict__ out,
                 const int32_t* __restrict__ rows, long long B, unsigned S) {
  constexpr unsigned SPW = 32 / SIGMA;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned chunks = SPW * S;               // 128-B chunks of one VSS
  const unsigned dk = 32u / S, ds = 32u % S;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                            // b is warp-uniform
  const uint32_t mw = __ldg(masks + b * 32 + lane);
  if (MARK && !__any_sync(kFull, mw != 0u)) return;  // a dummy VSS
  const uint32_t* fb = fbytes + b * S;
  int32_t* y = static_cast<int32_t*>(out) + b * (long long)(chunks * 32u) +
               lane;
  uint8_t* marks = static_cast<uint8_t*>(out);
  const int32_t* rid = rows + b * (SPW * 32u);
  unsigned k = lane / S, s = lane % S;
  for (unsigned c = 0; c < chunks; ++c) {
    const uint32_t hit = slice_of<SIGMA>(mw, k) & __ldg(fb + s);
    if (!MARK)
      y[c * 32u] = __popc(hit);
    else if (hit)
      marks[(long long)__ldg(rid + k) * S + s] = 1;
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

template <int SIGMA, bool MARK>
void launch(const void* masks, const void* fbytes, void* out,
            const void* rows, long long B, int S, cudaStream_t stream) {
  const uint32_t* m = static_cast<const uint32_t*>(masks);
  const uint32_t* f = static_cast<const uint32_t*>(fbytes);
  const int32_t* r = static_cast<const int32_t*>(rows);
  int lq = -1;
  for (int q = 0; q <= 5; ++q)
    if (S == (4 << q)) lq = q;
  if (lq >= 0) {
    const int fvec = reinterpret_cast<uintptr_t>(fbytes) % 16 == 0;
    bvss_spmm_quads<SIGMA, MARK><<<grid_for(B), kThreads, 0, stream>>>(
        m, f, out, r, B, lq, fvec);
  } else {
    bvss_spmm_scalar<SIGMA, MARK><<<grid_for(B), kThreads, 0, stream>>>(
        m, f, out, r, B, (unsigned)S);
  }
}

template <bool MARK>
int dispatch(const void* masks, const void* fbytes, void* out,
             const void* rows, long long B, int S, int sigma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (sigma) {
    case 1: launch<1, MARK>(masks, fbytes, out, rows, B, S, s); break;
    case 2: launch<2, MARK>(masks, fbytes, out, rows, B, S, s); break;
    case 4: launch<4, MARK>(masks, fbytes, out, rows, B, S, s); break;
    case 8: launch<8, MARK>(masks, fbytes, out, rows, B, S, s); break;
    case 16: launch<16, MARK>(masks, fbytes, out, rows, B, S, s); break;
    case 32: launch<32, MARK>(masks, fbytes, out, rows, B, S, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvss_spmm_launch(const void* masks, const void* fbytes,
                                void* out, long long B, int S, int sigma,
                                void* stream) {
  return dispatch<false>(masks, fbytes, out, nullptr, B, S, sigma, stream);
}

extern "C" int bvss_spmm_mark_launch(const void* masks, const void* fbytes,
                                     const void* row_ids, void* marks,
                                     long long B, int S, int sigma,
                                     void* stream) {
  return dispatch<true>(masks, fbytes, marks, row_ids, B, S, sigma, stream);
}

extern "C" const char* bvss_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
