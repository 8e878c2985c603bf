// Joint 16^3 vote histogram and its peak in one launch, hand-written for sm_90a.
//
// Replaces the Pallas TPU kernel cppf2_tpu/ops/pallas_kernels.py::_hist16_kernel
// (pallas_call at :69) together with the quantization, in-window test and
// argmax of its XLA twin cppf2_tpu/ops/voting.py::_hist16_matmul: for V
// candidate points, ids = floor((cand - lo) / cell + 0.5) per axis; a vote
// counts when ok and 0 <= ids < 16 on every axis; the result is the center
// lo + ids * cell of the fullest cell (ties go to the lowest flat index
// x*256 + y*16 + z) and its exact count.
//
// Two entry points share the counting and the peak:
//   cppf2_hist16_peak        votes read from a (V, 3) candidate array;
//   cppf2_hist16_level_peak  one level of the center vote for B rows at once
//       (a row is one instance's branch; the JAX package reaches this by
//       jax.vmap over branches and instances): every (pair, sample)
//       candidate c + (cos t * x0 + sin t * y0) * odist is made in registers
//       from the per-pair quantities and the level's sample table, quantized
//       and counted; no candidate is ever written to device memory. Each
//       product and sum is a separate round-to-nearest operation in the order
//       of the plain PyTorch version, and cosf/sinf are the library's accurate
//       ones, so that every vote falls into the same cell as there.
//
// Design. The TPU kernel builds one-hot factors and contracts them on the MXU,
// because the TPU has no fast scatter. Hopper has fast shared-memory atomics:
// each block keeps a 4096-bin int32 histogram in shared memory and merges its
// nonzero bins into the global counts with global atomics. The last block to
// finish (an atomic ticket taken after a __threadfence) takes the argmax over
// the 4096 counts as a max over (count << 32 | 4095 - index), which breaks
// ties toward the lowest index, writes center and count, and clears the
// counts and the ticket, so that the caller's scratch buffer is zero again
// for the next call on the stream: one launch, no memset, no second kernel.
// Counts are integers, so the order of the atomics cannot change them. The
// division is IEEE (no fast-math flags), as XLA divides.
//
// Votes pile onto a few cells near the peak, and neighbouring samples of one
// pair's arc mostly share a cell, so the adds to one shared word contend. The
// lanes of a warp that hold the same bin (__match_any_sync) therefore send one
// atomicAdd of their number. A private 16 KB histogram per warp, merged when
// the block is done, was measured beside it on the card (H100 80GB HBM3 at
// 700 W) and differed by at most 3 microseconds of a call's 9 to 15: the adds
// are not what a call waits for. The fixed parts are the launch, the merge of
// up to 4096 bins per block, and the last block's pass over the counts. The
// aggregated adds stayed because they leave room for more blocks per SM.
//
// Rows. blockIdx.y is the row and blockIdx.x strides that row's votes; each
// row has its own window, its own 4096 counts and ticket in the scratch and
// its own (4,) result, so a row's peak is exactly the one a launch of that
// row alone gives. The blocks per row follow the single-row formula, capped
// so that all rows together stay near kMaxBlocks: 16 rows at the fine level
// launch 16 x 16 blocks instead of 16 x 196.
//
// Bound on the H100 at the fine-level size (V = 400k): the candidate array is
// 13 bytes a vote (3 f32 + 1 bool), 5.2 MB, about 1.6 us at 3.35 TB/s; the
// fused level reads 49 bytes a pair (2.5 MB at 50,000 pairs) and is bound by
// its arithmetic instead (two library trig calls a vote). Either way a call
// is a few microseconds of work, and what it costs beyond that is the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 4096;
// 512 threads and up to two blocks per SM measured fastest (256 to 1024
// threads, 66 to 264 blocks tried)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 264;

struct Window {
  float lx, ly, lz, cx, cy, cz;
};

// The flat cell of a point, or -1 outside the window.
__device__ __forceinline__ int cell_of(float x, float y, float z, const Window& w) {
  const float fx = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(x, w.lx), w.cx), 0.5f));
  const float fy = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(y, w.ly), w.cy), 0.5f));
  const float fz = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(z, w.lz), w.cz), 0.5f));
  if (fx >= 0.f && fx < 16.f && fy >= 0.f && fy < 16.f && fz >= 0.f && fz < 16.f) {
    return (static_cast<int>(fx) * 16 + static_cast<int>(fy)) * 16 + static_cast<int>(fz);
  }
  return -1;
}

// Votes read from memory (one row).
struct CandVotes {
  const float* cand;
  const uint8_t* ok;
  __device__ __forceinline__ int operator()(int /*row*/, int i, const Window& w) const {
    if (!ok[i]) return -1;
    return cell_of(cand[3 * i], cand[3 * i + 1], cand[3 * i + 2], w);
  }
};

// Votes made on the fly: vote i of a row is sample i % n_smp of that row's
// pair i / n_smp; the per-pair arrays hold n_pairs pairs a row, row after row.
// With theta_star == nullptr the table holds cos (first n_smp) and sin (next
// n_smp) of angles shared by all pairs and rows; otherwise it holds the arc
// positions ts, and the angle is theta_star + ts * span of the pair.
struct LevelVotes {
  const float* c;
  const float* x0;
  const float* y0;
  const float* odist;
  const uint8_t* ok;
  const float* table;
  const float* theta_star;
  const float* span;
  int n_pairs;
  int n_smp;
  __device__ __forceinline__ int operator()(int row, int i, const Window& w) const {
    const int local = i / n_smp;
    const int smp = i - local * n_smp;
    const size_t pair = static_cast<size_t>(row) * n_pairs + local;
    if (!ok[pair]) return -1;
    float cs, sn;
    if (theta_star == nullptr) {
      cs = table[smp];
      sn = table[n_smp + smp];
    } else {
      const float theta = __fadd_rn(theta_star[pair], __fmul_rn(table[smp], span[pair]));
      cs = cosf(theta);
      sn = sinf(theta);
    }
    const float od = odist[pair];
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dir = __fadd_rn(__fmul_rn(cs, x0[3 * pair + a]), __fmul_rn(sn, y0[3 * pair + a]));
      p[a] = __fadd_rn(c[3 * pair + a], __fmul_rn(dir, od));
    }
    return cell_of(p[0], p[1], p[2], w);
  }
};

// Per row (blockIdx.y): n votes; lo, cell (3,); scratch 4096 counts and a
// ticket, all zero on entry and on exit; out: center x, y, z and the peak count.
template <typename Votes>
__global__ void __launch_bounds__(kThreads)
hist16_kernel(Votes votes, int n, const float* __restrict__ lo, const float* __restrict__ cell,
              int* __restrict__ scratch, float* __restrict__ out) {
  __shared__ int sh[kBins];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ int is_last;
  const int row = blockIdx.y;
  lo += 3 * row;
  cell += 3 * row;
  scratch += static_cast<size_t>(row) * (kBins + 1);
  out += 4 * row;
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh[i] = 0;
  __syncthreads();

  const Window w = {lo[0], lo[1], lo[2], cell[0], cell[1], cell[2]};
  const int lane = threadIdx.x & 31;
  // the bound is the same for a whole block: every lane reaches the match
  for (int i0 = blockIdx.x * kThreads; i0 < n; i0 += gridDim.x * kThreads) {
    const int i = i0 + threadIdx.x;
    const int bin = i < n ? votes(row, i, w) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sh[bin], __popc(peers));
  }
  __syncthreads();
  int* counts = scratch;
  int* ticket = scratch + kBins;
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const int v = sh[b];
    if (v) atomicAdd(&counts[b], v);
  }
  __threadfence();  // this block's counts are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block: argmax, then leave the scratch zeroed
  unsigned long long best = 0ull;
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const unsigned int v = static_cast<unsigned int>(__ldcg(&counts[b]));
    counts[b] = 0;
    const unsigned long long key =
        (static_cast<unsigned long long>(v) << 32) | static_cast<unsigned int>(kBins - 1 - b);
    best = key > best ? key : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
    best = other > best ? other : best;
  }
  if (lane == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) best = warp_best[k] > best ? warp_best[k] : best;
    const int idx = kBins - 1 - static_cast<int>(best & 0xffffffffull);
    const int ids[3] = {idx >> 8, (idx >> 4) & 15, idx & 15};
    for (int a = 0; a < 3; ++a) {
      out[a] = __fadd_rn(lo[a], __fmul_rn(static_cast<float>(ids[a]), cell[a]));
    }
    out[3] = static_cast<float>(best >> 32);
    *ticket = 0;
  }
}

template <typename Votes>
int launch(const Votes& votes, int n, int rows, const void* lo, const void* cell, void* scratch,
           void* out, void* stream) {
  const int cap = rows < kMaxBlocks ? kMaxBlocks / rows : 1;
  int blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  const dim3 grid(blocks, rows);
  hist16_kernel<Votes><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      votes, n, static_cast<const float*>(lo), static_cast<const float*>(cell),
      static_cast<int*>(scratch), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand (n, 3) f32, ok (n,) uint8, lo/cell (3,) f32; scratch (4097,) int32, zero
// on entry and left zero; writes out (4,) f32: the center and the peak count.
// Returns cudaGetLastError() after the launch.
extern "C" int cppf2_hist16_peak(const void* cand, const void* ok, int n, const void* lo,
                                 const void* cell, void* scratch, void* out, void* stream) {
  const CandVotes votes = {static_cast<const float*>(cand), static_cast<const uint8_t*>(ok)};
  return launch(votes, n, 1, lo, cell, scratch, out, stream);
}

// For `rows` rows: c, x0, y0 (rows, n_pairs, 3) f32, odist (rows, n_pairs)
// f32, ok (rows, n_pairs) uint8; table (2 * n_smp,) f32 cos then sin when
// theta_star is null, else (n_smp,) arc positions with theta_star and span
// (rows, n_pairs) f32; lo, cell (rows, 3) f32; scratch (rows, 4097) int32,
// zero on entry and left zero; writes out (rows, 4). Returns
// cudaGetLastError() after the launch.
extern "C" int cppf2_hist16_level_peak(const void* c, const void* x0, const void* y0,
                                       const void* odist, const void* ok, const void* table,
                                       const void* theta_star, const void* span, int rows,
                                       int n_pairs, int n_smp, const void* lo, const void* cell,
                                       void* scratch, void* out, void* stream) {
  const LevelVotes votes = {static_cast<const float*>(c),     static_cast<const float*>(x0),
                            static_cast<const float*>(y0),    static_cast<const float*>(odist),
                            static_cast<const uint8_t*>(ok),  static_cast<const float*>(table),
                            static_cast<const float*>(theta_star),
                            static_cast<const float*>(span),  n_pairs, n_smp};
  return launch(votes, n_pairs * n_smp, rows, lo, cell, scratch, out, stream);
}
