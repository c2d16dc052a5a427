// Fused end-of-level sweep for Hopper (sm_90a): finalise + frontier pack +
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
// frontier word and 1/sigma B of flag per vertex (~17.8 MB at N = 4,194,304,
// sigma = 8, ~5.3 us at 3.35 TB/s); lazy also reads 1 B of mark and writes
// 4 B of level per vertex (~38.8 MB, ~11.6 us).
//
// Design: one thread per vertex v over max(N, 32 * n_fwords, sigma * n_sets)
// rounded up to whole blocks.  Loads and the lazy level store are coalesced
// 4-byte accesses.  __ballot_sync turns the warp's 32 "new" predicates into
// the frontier word, which lane 0 stores.  sigma divides 32, so a slice set
// never straddles a word: the lanes with v % sigma == 0 read their sigma bits
// of the ballot and store the set flag.  Past N a vertex is never new, the
// same answer as the reference's padding with levels = 0.  The lazy mode may
// write levels' in place over levels: each thread reads and writes only its
// own vertex.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int SIGMA, bool LAZY>
__global__ void finalize_pack_kernel(const int32_t* levels,
                                     const uint8_t* __restrict__ marks,
                                     int32_t* levels_out,
                                     uint32_t* __restrict__ fwords,
                                     uint8_t* __restrict__ act, long long N,
                                     long long n_fwords, long long n_sets,
                                     int lvl) {
  constexpr uint32_t SMASK = SIGMA == 32 ? 0xffffffffu : ((1u << SIGMA) - 1u);
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool is_new = false;
  if (v < N) {
    const int32_t lv = levels[v];
    if (LAZY) {
      is_new = marks[v] > 0 && lv == INT_MAX;
      levels_out[v] = is_new ? lvl : lv;
    } else {
      is_new = lv == lvl;
    }
  }
  // every thread of the grid reaches the ballot: the mask is the full warp
  const uint32_t word = __ballot_sync(0xffffffffu, is_new);
  const long long w = v >> 5;
  if (lane == 0 && w < n_fwords) fwords[w] = word;
  if (lane % SIGMA == 0) {
    const long long s = v / SIGMA;
    if (s < n_sets) act[s] = ((word >> lane) & SMASK) != 0u;
  }
}

template <int SIGMA>
void launch(const void* levels, const void* marks, void* levels_out,
            void* fwords, void* act, long long N, long long n_fwords,
            long long n_sets, int lvl, cudaStream_t stream) {
  long long need = N;
  if (n_fwords * 32 > need) need = n_fwords * 32;
  if (n_sets * SIGMA > need) need = n_sets * SIGMA;
  const long long blocks = (need + kThreads - 1) / kThreads;
  const int32_t* lv = static_cast<const int32_t*>(levels);
  uint32_t* fw = static_cast<uint32_t*>(fwords);
  uint8_t* ac = static_cast<uint8_t*>(act);
  if (marks == nullptr) {
    finalize_pack_kernel<SIGMA, false><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(
        lv, nullptr, nullptr, fw, ac, N, n_fwords, n_sets, lvl);
  } else {
    finalize_pack_kernel<SIGMA, true><<<(unsigned)blocks, kThreads, 0,
                                        stream>>>(
        lv, static_cast<const uint8_t*>(marks),
        static_cast<int32_t*>(levels_out), fw, ac, N, n_fwords, n_sets, lvl);
  }
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

extern "C" const char* frontier_finalize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
