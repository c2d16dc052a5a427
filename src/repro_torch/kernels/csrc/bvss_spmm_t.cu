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
// sigma = 8, S = 8 that is 4,224 B read per 256 B written, so rmat(18)'s
// 38,852 VSSs read 164.1 MB and write 9.9 MB, 52.0 us at 3.35 TB/s.  The
// adds (tau predicated adds per output, 8,192 per VSS there) are about
// 30 us of issue over the card: below the bytes, but not by much, so the
// design keeps the instructions per add few.
//
// Tensor cores are not used.  An MMA sums its products in an order of its
// own, and TF32 rounds the values, so neither would equal the ascending f32
// chain of the twin (kernels/ref.py::bvss_spmm_t_ref), which the Brandes
// sums depend on.
//
// Design: a warp per (VSS, column tile).  A tile is the (tau, SC) block of
// row values, SC the largest power of two <= min(S, sigma), so it holds at
// most 1,024 floats (4 KB; at sigma = 8, S = 8 the VSS's whole contiguous
// block).  The warp first issues the tile's copies into shared memory with
// cp.async, 16 bytes a lane (512 contiguous bytes an instruction) when S %
// 4 == 0 and the rows are 16-byte aligned, else 4 bytes; it waits only
// after issuing all of them, and the other warps of the SM reduce while it
// waits, which keeps the row values streaming.  The VSS's 32 mask words
// are one 128-byte load, lane l word l, and a 32 x 32 bit transpose across
// the warp (five __shfl_xor_sync) leaves lane c holding bit c of every word:
// bit l of it is whether row 32*j + l of column c = sigma*j + i is set.
// Lane L owns column c = L % SC of the tile and the outputs i = L / SC,
// L / SC + 32 / SC, ...; it walks k = 0 .. tau-1 ascending, reads the value
// h[k, c] once from shared memory (lanes of one c read one word, neighbour
// c neighbour banks) and adds it to each of its outputs whose bit is set:
// every output is the twin's chain, in the twin's order, so the two are
// equal bit for bit, and a lane's outputs are independent chains.  The
// outputs of a tile row are contiguous, so the stores coalesce.  Larger S
// takes more tiles (more warps), never more shared memory.  A block holds
// 8 warps and the grid is sized to the work, with an early return.  Every
// launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileFloats = 1024;               // tau * SC <= 1024
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Lane l holds word l of a 32 x 32 bit matrix; afterwards lane c holds its
// column c: bit l of the result is bit c of lane l's word.  Each step swaps
// the off-diagonal j x j blocks with the partner lane l ^ j.
__device__ __forceinline__ uint32_t transpose_bits(uint32_t w,
                                                   unsigned lane) {
  uint32_t m = 0x0000ffffu;                     // bit positions with bit j 0
#pragma unroll
  for (unsigned j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t x = __shfl_xor_sync(kFull, w, j);
    w = (lane & j) ? ((w & ~m) | ((x >> j) & m)) : ((w & m) | ((x & m) << j));
  }
  return w;
}

template <int SIGMA>
__global__ void __launch_bounds__(kThreads)
bvss_spmm_t_kernel(const uint32_t* __restrict__ masks,
                   const float* __restrict__ hvals, float* __restrict__ out,
                   long long items, int S, int lsc, int tiles, int vec) {
  constexpr int SPW = 32 / SIGMA;
  constexpr int TAU = 32 * SPW;
  constexpr int MMAX = (SIGMA * SIGMA + 31) / 32;  // outputs of one lane
  __shared__ __align__(16) float stage[kWarps][kTileFloats];
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= items) return;                    // item is warp-uniform
  const long long b = item / tiles;
  const int SC = 1 << lsc;
  const int s0 = (int)(item - b * tiles) << lsc;
  const int sc = min(SC, S - s0);               // columns of this tile
  float* st = stage[warp];                      // (TAU, SC) row-major
  const float* h = hvals + b * TAU * (long long)S + s0;

  // 1. issue the tile's copies, row k and copy c stepped without division
  const int per_row = vec ? (sc >> 2) : sc;
  const int width = vec ? 4 : 1;
  int k = (int)lane / per_row, c = (int)lane % per_row;
  const int dk = 32 / per_row, dc = 32 % per_row;
  for (int e = (int)lane; e < TAU * per_row; e += 32) {
    float* dst = st + k * SC + c * width;
    const float* src = h + (long long)k * S + c * width;
    if (vec)
      copy16(dst, src);
    else
      copy4(dst, src);
    k += dk;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++k;
    }
  }

  // 2. the mask bits by column while the copies fly
  const uint32_t cols = transpose_bits(__ldg(masks + b * 32 + lane), lane);
  const int col = (int)lane & (SC - 1);
  const int i0 = (int)lane >> lsc;
  const int di = 32 >> lsc;
  wait_copies();
  __syncwarp();

  // 3. ascending k; one shared read serves every output of the lane
  float acc[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) acc[m] = 0.f;
#pragma unroll
  for (int j = 0; j < SPW; ++j) {
    uint32_t bits[MMAX];                        // rows 32j .. 32j+31
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
      bits[m] = __shfl_sync(kFull, cols, (SIGMA * j + i0 + m * di) & 31);
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      const float v = st[(j * 32 + l) * SC + col];
#pragma unroll
      for (int m = 0; m < MMAX; ++m)
        if ((bits[m] >> l) & 1u) acc[m] += v;
    }
  }

  // 4. outputs (i, s0 + col); a tile row's outputs are contiguous
  if (col < sc) {
    float* y = out + b * SIGMA * (long long)S + s0 + col;
#pragma unroll
    for (int m = 0; m < MMAX; ++m) {
      const int i = i0 + m * di;
      if (i < SIGMA) y[(long long)i * S] = acc[m];
    }
  }
}

template <int SIGMA>
int launch(const void* masks, const void* hvals, void* out, long long B,
           int S, cudaStream_t stream) {
  int lsc = 0;                                  // SC = largest 2^q <= min
  while ((2 << lsc) <= (S < SIGMA ? S : SIGMA)) ++lsc;
  const int tiles = (S + (1 << lsc) - 1) >> lsc;
  // 16-byte copies: every tile row starts 16-byte aligned and is whole quads
  const int vec = S % 4 == 0 && lsc >= 2 &&
                  reinterpret_cast<uintptr_t>(hvals) % 16 == 0;
  const long long items = B * tiles;
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  bvss_spmm_t_kernel<SIGMA><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(masks), static_cast<const float*>(hvals),
      static_cast<float*>(out), items, S, lsc, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bvss_spmm_t_launch(const void* masks, const void* hvals,
                                  void* out, long long B, int S, int sigma,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
