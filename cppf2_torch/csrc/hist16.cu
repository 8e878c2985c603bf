// Joint 16^3 vote histogram and its peak, hand-written for sm_90a.
//
// Replaces the Pallas TPU kernel cppf2_tpu/ops/pallas_kernels.py::_hist16_kernel
// (pallas_call at :69) together with the quantization, in-window test and
// argmax of its XLA twin cppf2_tpu/ops/voting.py::_hist16_matmul: for V
// candidate points, ids = floor((cand - lo) / cell + 0.5) per axis; a vote
// counts when ok and 0 <= ids < 16 on every axis; the result is the center
// lo + ids * cell of the fullest cell (ties go to the lowest flat index
// x*256 + y*16 + z) and its exact count.
//
// Design. The TPU kernel builds one-hot factors and contracts them on the
// MXU, because the TPU has no fast scatter. Hopper has fast shared-memory
// atomics, so pass 1 keeps one 4096-bin int32 histogram per block in shared
// memory, quantizes each vote in registers and adds it with a shared atomic,
// then merges the block's nonzero bins into the global counts with global
// atomics. Pass 2 is one block that takes the argmax over the 4096 counts as a
// max over (count << 32 | 4095 - index), which breaks ties toward the lowest
// index. Counts are integers, so the order of the atomics cannot change them.
// The division is IEEE (no fast-math flags), as XLA divides.
//
// Bound on the H100 at the fine-level size (V = 400k): the votes are 13 bytes
// each (3 f32 + 1 bool), 5.2 MB read in all, about 1.6 us at 3.35 TB/s; the
// call is bound by its two launches more than by memory. Votes pile onto a few
// cells near the peak, so the shared atomics on those bins contend.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 4096;
constexpr int kCountThreads = 256;
constexpr int kPeakThreads = 1024;

__global__ void __launch_bounds__(kCountThreads)
hist16_count_kernel(const float* __restrict__ cand, const uint8_t* __restrict__ ok, int n,
                    const float* __restrict__ lo, const float* __restrict__ cell,
                    int* __restrict__ counts) {
  __shared__ int sh[kBins];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const float lx = lo[0], ly = lo[1], lz = lo[2];
  const float cx = cell[0], cy = cell[1], cz = cell[2];
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (!ok[i]) continue;
    const float fx = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(cand[3 * i + 0], lx), cx), 0.5f));
    const float fy = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(cand[3 * i + 1], ly), cy), 0.5f));
    const float fz = floorf(__fadd_rn(__fdiv_rn(__fsub_rn(cand[3 * i + 2], lz), cz), 0.5f));
    if (fx >= 0.f && fx < 16.f && fy >= 0.f && fy < 16.f && fz >= 0.f && fz < 16.f) {
      const int bin = (static_cast<int>(fx) * 16 + static_cast<int>(fy)) * 16 + static_cast<int>(fz);
      atomicAdd(&sh[bin], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) {
    if (sh[i]) atomicAdd(&counts[i], sh[i]);
  }
}

__global__ void __launch_bounds__(kPeakThreads)
hist16_peak_kernel(const int* __restrict__ counts, const float* __restrict__ lo,
                   const float* __restrict__ cell, float* __restrict__ center,
                   float* __restrict__ peak) {
  __shared__ unsigned long long warp_best[kPeakThreads / 32];
  unsigned long long best = 0ull;
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<unsigned int>(counts[b])) << 32) |
        static_cast<unsigned int>(kBins - 1 - b);
    best = key > best ? key : best;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
    best = other > best ? other : best;
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPeakThreads / 32; ++w) best = warp_best[w] > best ? warp_best[w] : best;
    const int idx = kBins - 1 - static_cast<int>(best & 0xffffffffull);
    const int ids[3] = {idx >> 8, (idx >> 4) & 15, idx & 15};
    for (int a = 0; a < 3; ++a) {
      center[a] = __fadd_rn(lo[a], __fmul_rn(static_cast<float>(ids[a]), cell[a]));
    }
    peak[0] = static_cast<float>(best >> 32);
  }
}

}  // namespace

// cand (n, 3) f32, ok (n,) uint8, lo/cell (3,) f32, counts (4096,) int32 zeroed
// by the caller; writes center (3,) f32 and peak () f32. Returns
// cudaGetLastError() after both launches.
extern "C" int cppf2_hist16_peak(const void* cand, const void* ok, int n, const void* lo,
                                 const void* cell, void* counts, void* center, void* peak,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = (n + 4 * kCountThreads - 1) / (4 * kCountThreads);
  blocks = blocks < 1 ? 1 : (blocks > 264 ? 264 : blocks);
  hist16_count_kernel<<<blocks, kCountThreads, 0, st>>>(
      static_cast<const float*>(cand), static_cast<const uint8_t*>(ok), n,
      static_cast<const float*>(lo), static_cast<const float*>(cell), static_cast<int*>(counts));
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  hist16_peak_kernel<<<1, kPeakThreads, 0, st>>>(
      static_cast<const int*>(counts), static_cast<const float*>(lo),
      static_cast<const float*>(cell), static_cast<float*>(center), static_cast<float*>(peak));
  return static_cast<int>(cudaGetLastError());
}
