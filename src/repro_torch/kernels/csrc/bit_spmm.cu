// Dense popcount-semiring SpMM for Hopper (sm_90a): Y = bits(A)[:, :C] @ X.
//
//   y[r, s] = sum of x[c, s] over the columns c < C whose bit is set in row r
//
// A is (R, W) uint32 words (bit i of word w is column 32w + i), X is (C, S)
// int8, Y is (R, S) int32.  Bits at columns >= C count nothing.  The sums
// are exact integers for any int8 X, negatives included.
//
// Replaces: repro/kernels/mxu_pull.py::bit_spmm (_mxu_kernel), the Pallas
// kernel that unpacks 128-column stripes of A to int8 and contracts them
// with X on the TPU's matrix unit.  It is the dense multi-source baseline's
// pull (one row per vertex of the to_dense_bits adjacency).
//
// Bound on an H100: memory.  It reads R*W*4 B of A, C*S B of X and writes
// R*S*4 B of Y: at R = C = 65,536, S = 8 that is 539.5 MB, ~161 us at
// 3.35 TB/s.  The arithmetic is one add per set bit and column (about 8M on
// the directed rmat(16) adjacency's 1M edges), far below the integer rate.
// A graph's adjacency is sparse, so the kernel is a stream over A.
//
// Design: one warp per row.  The lanes stride over the row's first
// ceil(C/32) words, eight words in flight per lane: two 16-byte loads when
// the rows are 16-byte aligned (W % 4 == 0 and an aligned base, the wrapper
// passes vec), else eight 4-byte loads; each step of the warp reads 1 KB.
// Words at or past ceil(C/32) are dropped and the last one is masked at
// column C.  A lane walks the set bits of its words with __ffs and adds
// x[c, s0..s0+7] into 8 int32 registers; a butterfly of shuffles sums the
// 32 lanes and lane 0 stores the 8 outputs.  Columns go in passes of 8,
// each pass reading the row again (from L1/L2 at the small shapes that
// have many columns).  A tensor-core form (b1 or int8 MMA) is later work.
// Every launch returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kCols = 8;            // output columns per pass

__device__ __forceinline__ void add_bits(const int8_t* __restrict__ x,
                                         long long S, int s0, int ns,
                                         uint32_t word, long long c0,
                                         int (&acc)[kCols]) {
  while (word) {
    const int bit = __ffs(word) - 1;
    word &= word - 1u;
    const int8_t* xr = x + (c0 + bit) * S + s0;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (j < ns) acc[j] += __ldg(xr + j);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bit_spmm_kernel(const uint32_t* __restrict__ a, const int8_t* __restrict__ x,
                int32_t* __restrict__ y, long long R, long long W,
                long long C, int S, int vec) {
  const long long r =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;               // r is the same for the whole warp
  const int lane = threadIdx.x & 31;
  const long long wc = (C + 31) / 32;              // words of columns < C
  const uint32_t last_mask =
      (C % 32) ? ((1u << (C % 32)) - 1u) : 0xffffffffu;
  const uint32_t* row = a + r * W;
  for (int s0 = 0; s0 < S; s0 += kCols) {
    const int ns = S - s0 < kCols ? S - s0 : kCols;
    int acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0;
    // one step: the lane's 8 words w[k] (k = 0..7) of this 256-word block
    for (long long base = 0; base < wc; base += 256) {
      uint32_t v[8];
      long long w[8];
      if (vec) {                    // words 4(lane + 32h) + i, h = 0, 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long w4 = base + 4 * (lane + 32 * h);
          const uint4 q = w4 < wc ? __ldg(reinterpret_cast<const uint4*>(
                                        row + w4))
                                  : make_uint4(0u, 0u, 0u, 0u);
          v[4 * h] = q.x;
          v[4 * h + 1] = q.y;
          v[4 * h + 2] = q.z;
          v[4 * h + 3] = q.w;
#pragma unroll
          for (int i = 0; i < 4; ++i) w[4 * h + i] = w4 + i;
        }
      } else {                      // words lane + 32k
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          w[k] = base + lane + 32 * k;
          v[k] = w[k] < wc ? __ldg(row + w[k]) : 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t word = w[k] < wc ? v[k] : 0u;
        if (w[k] == wc - 1) word &= last_mask;
        add_bits(x, S, s0, ns, word, w[k] * 32, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      int t = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      acc[j] = t;
    }
    if (lane == 0) {
      int32_t* out = y + r * S + s0;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (j < ns) out[j] = acc[j];
    }
  }
}

}  // namespace

// vec = 1: every row starts 16-byte aligned (checked by the wrapper).
extern "C" int bit_spmm_launch(const void* a, const void* x, void* y,
                               long long R, long long W, long long C, int S,
                               int vec, void* stream) {
  const long long blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bit_spmm_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const int8_t*>(x),
      static_cast<int32_t*>(y), R, W, C, S, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bit_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
