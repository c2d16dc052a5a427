// End-of-level sweeps for Hopper (sm_90a).  Two entry points:
//
// finalize_pack_launch: the fused sweep, finalise + frontier pack +
// slice-set flags in one pass over the vertices.
//
//   eager: new[v] = levels[v] == lvl          (levels already scatter-min'd)
//   lazy:  new[v] = marks[v] > 0 && levels[v] == INF, levels'[v] = lvl if new
//   both:  fwords[w] bit i = new[32w + i]; act[s] = any(new[sigma*s ...+sigma])
//
// Replaces: repro/kernels/frontier_finalize.py::finalize_pack_sweep
// (_finalize_pack_eager, _finalize_pack_lazy and their shared _emit_packed).
//
// Bound on an H100: memory.  Eager reads 4 B per vertex and writes 1/8 B of
// frontier word and 1/sigma B of flag per vertex (17.8 MB at N = 4,194,304,
// sigma = 8, 5.32 us at 3.35 TB/s); lazy also reads 1 B of mark and writes
// 4 B of level per vertex (38.8 MB, 11.58 us).
//
// Design: HBM3 streams at its rate only with a few MB in flight, so each
// lane takes four vertices per access (an int4 of levels and, lazy, a
// uchar4 of marks) and issues the loads of two such passes before it uses
// either: a warp pass covers 128 vertices, a warp step two passes, with
// 1 KB of levels in flight per warp; offsets are 64-bit once a step and
// 32-bit within it.  The grid has a warp per step in 128-thread blocks:
// on the H100 a persistent grid of resident blocks was slower, one or four
// passes a step or 256-thread blocks no faster.
// Packing: each lane's four "new" bits form a nibble; three
// __shfl_xor_sync steps OR the nibbles of the eight lanes that own a
// 32-vertex word, and lanes 0, 8, 16, 24 store the pass's four words, one
// 16-byte run.  Flags: at sigma >= 4 the first lane of each slice set
// reads the set's sigma bits out of the word it holds; at sigma < 4 every
// lane writes the 4/sigma flags of its own nibble.  A pass's 128/sigma
// flags are thus one contiguous run of one store instruction (16 B at
// sigma = 8; a flag per vertex at sigma = 1, per word at sigma = 32).  A
// quad that runs past N, or a levels, marks or levels' view that is not
// aligned for the wide accesses, takes the one-vertex-at-a-time path.
// Past N a vertex is never new, the same answer as the reference's padding
// with levels = 0; words and flags at or past n_fwords and n_sets are not
// written.  The lazy mode may write levels' in place over levels: each
// lane reads and writes only its own vertices.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // finalize_sweep's blocks
constexpr int kPackThreads = 128;        // finalize_pack_kernel's blocks
constexpr int kWarps = kPackThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPass = 128;              // vertices of one warp pass
constexpr int kUnroll = 2;              // passes whose loads are in flight

// Words and flags of one warp pass.  `nib` holds the new bits of this
// lane's vertices 4*lane + 0..3 of the pass; `fw` and `ac` point at the
// pass's first word and first set, of which `wleft` and `sleft` exist.
template <int SIGMA>
__device__ __forceinline__ void emit_pass(unsigned nib, unsigned lane,
                                          uint32_t* __restrict__ fw,
                                          uint8_t* __restrict__ ac,
                                          int wleft, int sleft) {
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  constexpr unsigned LPS = SIGMA >= 4 ? SIGMA / 4 : 1;  // lanes per set
  constexpr int FPL = SIGMA >= 4 ? 1 : 4 / SIGMA;        // sets per lane
  uint32_t word = nib << (4u * (lane & 7u));
  word |= __shfl_xor_sync(kFull, word, 1);
  word |= __shfl_xor_sync(kFull, word, 2);
  word |= __shfl_xor_sync(kFull, word, 4);
  const int w = (int)(lane >> 3);
  if ((lane & 7u) == 0 && w < wleft) fw[w] = word;
  if (lane % LPS != 0) return;
  // the first lane of each set (sigma >= 4) or every lane (its 4/sigma
  // sets) writes its flag bytes: one contiguous run per pass
  uint32_t flags;
  if (SIGMA >= 4)
    flags = ((word >> (4u * (lane & 7u))) & SMASK) != 0u;
  else if (SIGMA == 2)
    flags = (uint32_t)((nib & 3u) != 0u) | (uint32_t)((nib & 12u) != 0u) << 8;
  else
    flags = (nib & 1u) | (nib & 2u) << 7 | (nib & 4u) << 14 | (nib & 8u) << 21;
  // s is a multiple of FPL, and act is the wrapper's fresh allocation, so
  // the 2- and 4-byte stores are aligned
  const int s = (int)(lane / LPS) * FPL;
  if (s + FPL <= sleft) {
    if (FPL == 4) *reinterpret_cast<uint32_t*>(ac + s) = flags;
    else if (FPL == 2) *reinterpret_cast<uint16_t*>(ac + s) = (uint16_t)flags;
    else ac[s] = (uint8_t)flags;
  } else {
    for (int i = 0; i < FPL && s + i < sleft; ++i)
      ac[s + i] = (uint8_t)(flags >> (8 * i));
  }
}

// How many of `count` items lie at or past `start`, capped at `cap`.
__device__ __forceinline__ int items_left(long long count, long long start,
                                          int cap) {
  const long long left = count - start;
  return left <= 0 ? 0 : (left < cap ? (int)left : cap);
}

template <int SIGMA, bool LAZY>
__global__ void __launch_bounds__(kPackThreads)
finalize_pack_kernel(const int32_t* levels, const uint8_t* __restrict__ marks,
                     int32_t* levels_out, uint32_t* __restrict__ fwords,
                     uint8_t* __restrict__ act, long long N,
                     long long n_fwords, long long n_sets, long long steps,
                     int lvl, int vec) {
  constexpr int STEP = kPass * kUnroll;          // vertices of a warp step
  const unsigned lane = threadIdx.x & 31u;
  const long long it = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (it >= steps) return;                       // it is warp-uniform
  // 64-bit offsets once a step; 32-bit offsets within it
  const long long base = it * STEP;
  const int32_t* lv_p = levels + base;
  const uint8_t* mk_p = LAZY ? marks + base : nullptr;
  int32_t* out_p = LAZY ? levels_out + base : nullptr;
  const int left = items_left(N, base, STEP);
  const int wleft = items_left(n_fwords, base / 32, STEP / 32);
  const int sleft = items_left(n_sets, base / SIGMA, STEP / SIGMA);
  int4 lv[kUnroll];
  uint32_t mk[kUnroll];
  bool wide[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int v0 = u * kPass + 4 * (int)lane;
    wide[u] = vec && v0 + 4 <= left;
    if (wide[u]) {
      lv[u] = *reinterpret_cast<const int4*>(lv_p + v0);
      if (LAZY) mk[u] = *reinterpret_cast<const uint32_t*>(mk_p + v0);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int v0 = u * kPass + 4 * (int)lane;
    unsigned nib = 0;
    if (wide[u]) {
      const int32_t l[4] = {lv[u].x, lv[u].y, lv[u].z, lv[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool is_new =
            LAZY ? ((mk[u] >> (8 * i)) & 0xffu) != 0u && l[i] == INT_MAX
                 : l[i] == lvl;
        nib |= (unsigned)is_new << i;
      }
      if (LAZY)
        *reinterpret_cast<int4*>(out_p + v0) = make_int4(
            nib & 1u ? lvl : l[0], nib & 2u ? lvl : l[1],
            nib & 4u ? lvl : l[2], nib & 8u ? lvl : l[3]);
    } else {
      for (int i = 0; i < 4 && v0 + i < left; ++i) {
        const int32_t l = lv_p[v0 + i];
        const bool is_new = LAZY ? mk_p[v0 + i] > 0 && l == INT_MAX
                                 : l == lvl;
        if (LAZY) out_p[v0 + i] = is_new ? lvl : l;
        nib |= (unsigned)is_new << i;
      }
    }
    const int wp = u * (kPass / 32), sp = u * (kPass / SIGMA);
    emit_pass<SIGMA>(nib, lane, fwords + base / 32 + wp,
                     act + base / SIGMA + sp, wleft - wp, sleft - sp);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int SIGMA, bool LAZY>
void launch_mode(const int32_t* levels, const uint8_t* marks,
                 int32_t* levels_out, uint32_t* fwords, uint8_t* act,
                 long long N, long long n_fwords, long long n_sets, int lvl,
                 cudaStream_t stream) {
  long long need = N;
  if (n_fwords * 32 > need) need = n_fwords * 32;
  if (n_sets * SIGMA > need) need = n_sets * SIGMA;
  const long long steps = (need + kPass * kUnroll - 1) / (kPass * kUnroll);
  const long long blocks = (steps + kWarps - 1) / kWarps;
  const int vec = aligned(levels, 16) &&
                  (!LAZY || (aligned(marks, 4) && aligned(levels_out, 16)));
  finalize_pack_kernel<SIGMA, LAZY><<<(unsigned)blocks, kPackThreads, 0,
                                      stream>>>(
      levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, steps, lvl,
      vec);
}

template <int SIGMA>
void launch(const void* levels, const void* marks, void* levels_out,
            void* fwords, void* act, long long N, long long n_fwords,
            long long n_sets, int lvl, cudaStream_t stream) {
  const int32_t* lv = static_cast<const int32_t*>(levels);
  uint32_t* fw = static_cast<uint32_t*>(fwords);
  uint8_t* ac = static_cast<uint8_t*>(act);
  if (marks == nullptr)
    launch_mode<SIGMA, false>(lv, nullptr, nullptr, fw, ac, N, n_fwords,
                              n_sets, lvl, stream);
  else
    launch_mode<SIGMA, true>(lv, static_cast<const uint8_t*>(marks),
                             static_cast<int32_t*>(levels_out), fw, ac, N,
                             n_fwords, n_sets, lvl, stream);
}

}  // namespace

// marks == nullptr selects the eager mode (no levels' stream).
extern "C" int finalize_pack_launch(const void* levels, const void* marks,
                                    void* levels_out, void* fwords, void* act,
                                    long long N, long long n_fwords,
                                    long long n_sets, int sigma, int lvl,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sigma) {
    case 1: launch<1>(levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, lvl, s); break;
    case 2: launch<2>(levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, lvl, s); break;
    case 4: launch<4>(levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, lvl, s); break;
    case 8: launch<8>(levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, lvl, s); break;
    case 16: launch<16>(levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, lvl, s); break;
    case 32: launch<32>(levels, marks, levels_out, fwords, act, N, n_fwords, n_sets, lvl, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// finalize_sweep_launch: the minimal unit sweep (Alg. 3 stage 2)
//
//   new[v] = marks[v] > 0 && levels[v] == INF;  levels'[v] = new ? lvl : levels[v]
//
// Replaces: repro/kernels/frontier_finalize.py::finalize_sweep
// (_finalize_kernel), kept there as the unit kernel and as the baseline of
// the fused sweep above.
//
// Bound on an H100: memory.  It reads 1 B of mark and 4 B of level and
// writes 4 B of level and 1 B of flag per vertex: 10 B, 41.9 MB at
// N = 4,194,304, ~12.5 us at 3.35 TB/s.  The compare and select are a few
// integer operations per vertex.
//
// Design: four vertices per thread, so a warp moves 512 B of levels and
// 128 B of marks per access; the wide path (uchar4 / int4 loads and stores)
// needs all four vertices in range and operands aligned (the wrapper
// checks the pointers and passes vec), the ragged tail and unaligned
// operands take one vertex at a time.  Outputs are new tensors, as the
// reference returns new arrays.
// ---------------------------------------------------------------------------
namespace {

__global__ void finalize_sweep_kernel(const uint8_t* __restrict__ marks,
                                      const int32_t* __restrict__ levels,
                                      int32_t* __restrict__ levels_out,
                                      uint8_t* __restrict__ new_out,
                                      long long N, int lvl, int vec) {
  const long long v0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (v0 >= N) return;
  if (vec && v0 + 4 <= N) {
    const uchar4 mk = *reinterpret_cast<const uchar4*>(marks + v0);
    const int4 lv = *reinterpret_cast<const int4*>(levels + v0);
    const bool n0 = mk.x > 0 && lv.x == INT_MAX;
    const bool n1 = mk.y > 0 && lv.y == INT_MAX;
    const bool n2 = mk.z > 0 && lv.z == INT_MAX;
    const bool n3 = mk.w > 0 && lv.w == INT_MAX;
    *reinterpret_cast<int4*>(levels_out + v0) =
        make_int4(n0 ? lvl : lv.x, n1 ? lvl : lv.y, n2 ? lvl : lv.z,
                  n3 ? lvl : lv.w);
    *reinterpret_cast<uchar4*>(new_out + v0) =
        make_uchar4(n0, n1, n2, n3);
    return;
  }
  const long long end = v0 + 4 < N ? v0 + 4 : N;
  for (long long v = v0; v < end; ++v) {
    const int32_t l = levels[v];
    const bool is_new = marks[v] > 0 && l == INT_MAX;
    levels_out[v] = is_new ? lvl : l;
    new_out[v] = is_new;
  }
}

}  // namespace

extern "C" int finalize_sweep_launch(const void* marks, const void* levels,
                                     void* levels_out, void* new_out,
                                     long long N, int lvl, int vec,
                                     void* stream) {
  const long long blocks = ((N + 3) / 4 + kThreads - 1) / kThreads;
  finalize_sweep_kernel<<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(marks), static_cast<const int32_t*>(levels),
      static_cast<int32_t*>(levels_out), static_cast<uint8_t*>(new_out), N,
      lvl, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* frontier_finalize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
