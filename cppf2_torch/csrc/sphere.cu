// Weighted thresholded-cosine votes on a sphere, hand-written for sm_90a.
//
// Replaces the Pallas TPU kernel cppf2_tpu/ops/pallas_kernels.py::_sphere_kernel
// (sphere_accumulate_pallas, pallas_call at :122) and the XLA matmul twins in
// cppf2_tpu/ops/voting.py::sphere_vote and cppf2_tpu/parallel/mesh.py: for B
// rows of V unit directions d with weights w and S sphere points p,
//   counts[b, s] = sum_v w[b, v] * [(d0*p0 + d1*p1) + d2*p2 > thresh],
// each cosine rounded in exactly that order (no FMA contraction), so that the
// hit test agrees bit for bit with the plain PyTorch version.
//
// Design. The TPU kernel takes a (chunk, S') cosine block on the MXU and keeps
// a (1, S') accumulator in VMEM across a sequential grid. Here blocks run in
// parallel and nothing carries over between them, so pass 1 gives each block
// one chunk of one row's votes and all S sphere points: each of 256 threads
// holds P sphere points (P = ceil(S / 256), at most 4; more sphere blocks
// along grid.z past 1024 points) and one f32 sum per point in registers. The
// block stages its votes through shared memory as float4 (x, y, z, w), 256 at
// a time, and every thread tests each staged vote against its points. The
// block writes its P sums per thread to a (B, n_chunks, S) partial buffer.
// Pass 2 adds the partials of each (b, s) in chunk order. There are no float
// atomics, so the counts are the same bits from run to run and ties of a
// later argmax resolve the same way every time.
//
// Bound on the H100 at the production shape (B = 1, V = 900k, S = 720): the
// work is 0.648 G (vote, point) pairs of 7 f32 instructions each (3 FMUL,
// 2 FADD, 1 FSETP, 1 predicated FADD; no FMA), 4.5 G instructions, 0.135 ms
// at 33.5 T f32 instructions/s (67 TFLOP/s counting an FMA as two). The votes
// are 14.4 MB, 4.3 us at 3.35 TB/s, so the kernel is bound by operations.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // votes staged in shared memory per step

template <int P>
__global__ void __launch_bounds__(kThreads)
sphere_partial_kernel(const float* __restrict__ dirs, const float* __restrict__ weights,
                      const float* __restrict__ sphere, int v, int s, int chunk, int n_chunks,
                      float thresh, float* __restrict__ partial) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int s0 = blockIdx.z * kThreads * P;
  float sx[P], sy[P], sz[P], acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = s0 + p * kThreads + threadIdx.x;
    // a slot past S tests against the origin and is never written back
    sx[p] = idx < s ? sphere[3 * idx + 0] : 0.f;
    sy[p] = idx < s ? sphere[3 * idx + 1] : 0.f;
    sz[p] = idx < s ? sphere[3 * idx + 2] : 0.f;
    acc[p] = 0.f;
  }
  const long long row = static_cast<long long>(b) * v;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, v);
  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();  // the previous tile has been read by every thread
    if (threadIdx.x < n) {
      const long long i = row + t0 + threadIdx.x;
      tile[threadIdx.x] = make_float4(dirs[3 * i + 0], dirs[3 * i + 1], dirs[3 * i + 2], weights[i]);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 d = tile[j];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float c = __fadd_rn(__fadd_rn(__fmul_rn(d.x, sx[p]), __fmul_rn(d.y, sy[p])),
                                  __fmul_rn(d.z, sz[p]));
        if (c > thresh) acc[p] = __fadd_rn(acc[p], d.w);
      }
    }
  }
  float* out = partial + (static_cast<long long>(b) * n_chunks + blockIdx.x) * s;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int idx = s0 + p * kThreads + threadIdx.x;
    if (idx < s) out[idx] = acc[p];
  }
}

__global__ void __launch_bounds__(kThreads)
sphere_reduce_kernel(const float* __restrict__ partial, int s, int n_chunks,
                     float* __restrict__ counts) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= s) return;
  const float* col = partial + static_cast<long long>(b) * n_chunks * s + idx;
  float sum = 0.f;
  for (int c = 0; c < n_chunks; ++c) sum = __fadd_rn(sum, col[static_cast<long long>(c) * s]);
  counts[static_cast<long long>(b) * s + idx] = sum;
}

template <int P>
void launch_partial(dim3 grid, cudaStream_t st, const float* dirs, const float* weights,
                    const float* sphere, int v, int s, int chunk, int n_chunks, float thresh,
                    float* partial) {
  sphere_partial_kernel<P><<<grid, kThreads, 0, st>>>(dirs, weights, sphere, v, s, chunk,
                                                      n_chunks, thresh, partial);
}

}  // namespace

// dirs (b, v, 3) f32, weights (b, v) f32, sphere (s, 3) f32, all contiguous;
// partial (b, n_chunks, s) f32 scratch with n_chunks = ceil(v / chunk);
// writes counts (b, s) f32. Returns cudaGetLastError() after both launches.
extern "C" int cppf2_sphere_accumulate(const void* dirs, const void* weights, const void* sphere,
                                       int b, int v, int s, float thresh, int chunk,
                                       int n_chunks, void* partial, void* counts,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || v < 0 || chunk < 1 || n_chunks != (v + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* d = static_cast<const float*>(dirs);
  const float* w = static_cast<const float*>(weights);
  const float* sph = static_cast<const float*>(sphere);
  float* part = static_cast<float*>(partial);
  if (n_chunks > 0) {
    int per_thread = (s + kThreads - 1) / kThreads;
    per_thread = per_thread > 4 ? 4 : per_thread;
    const dim3 grid(n_chunks, b, (s + kThreads * per_thread - 1) / (kThreads * per_thread));
    switch (per_thread) {
      case 1: launch_partial<1>(grid, st, d, w, sph, v, s, chunk, n_chunks, thresh, part); break;
      case 2: launch_partial<2>(grid, st, d, w, sph, v, s, chunk, n_chunks, thresh, part); break;
      case 3: launch_partial<3>(grid, st, d, w, sph, v, s, chunk, n_chunks, thresh, part); break;
      default: launch_partial<4>(grid, st, d, w, sph, v, s, chunk, n_chunks, thresh, part); break;
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  sphere_reduce_kernel<<<dim3((s + kThreads - 1) / kThreads, b), kThreads, 0, st>>>(
      part, s, n_chunks, static_cast<float*>(counts));
  return static_cast<int>(cudaGetLastError());
}
