// The frontend's kNN selection in one launch (kernel K6), hand-written for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this selection to XLA
// (cppf2_tpu/ops/neighbors.py::knn_radius_neighbors, `approx_min_k` over a
// (chunk, N) block of packed keys). It replaces the port's plain route on the
// card (ops/neighbors.py), which writes the whole (chunk, N) float32 block of
// keys to device memory through about nine elementwise passes and then runs
// torch.topk's radix select over it: about 5-6 GB of traffic for an
// instance of 8,192 points.
//
// What it computes, for each instance b of B clouds of n points (invalid
// points already parked at 1e6 by the wrapper) and each query point i: the
// k smallest packed keys over the columns j of its own cloud,
//   cross = fma(z_i, z_j, fma(y_i, y_j, x_i * x_j)),
//   d2    = (sq_i + sq_j) - 2 * cross,
//   key   = rint(min(max(d2, 0), r2) * scale) * n + j,
// with sq the wrapper's fma-chain norms, r2 = float(radius^2) and scale =
// float(levels / radius^2), every operation rounded as written (no
// contraction): the plain route's float32 arithmetic with its product taken
// as that fma chain, the rounding of cuBLAS's K = 3 product on the card and
// of MKL's on the CPU. The keys are distinct integers below 2^24, exact in
// float32, so the k smallest are unique. It writes their columns (key mod n)
// as int64, (B, n, k), nearest first, ties to the lower column: what
// torch.topk(sorted=True) gives. A row with fewer than k points in radius
// takes the clamped keys of the lowest columns, as the plain route does.
//
// Design. One block of 8 warps takes 32 queries of one instance, a warp 4
// of them (Q). The instance's points and norms pass through shared memory in
// tiles of 2,048 columns (x, y, z, sq: 32 KB). A lane makes the keys of one
// column for the warp's 4 queries, so a column is read from shared memory
// once for 4 keys. Registers are held to 64 a thread (4 blocks, 32 warps an
// SM) where k <= 96, 80 at k = 128: the insertions are chains of dependent
// shuffles, and more warps hide them better than more queries a warp (on the
// H100 at (8, 8192, 48), 8 queries a warp at 2 blocks an SM took 0.16 ms an
// instance, 4 at 4 blocks 0.12 ms; at one instance 0.29 and 0.18 ms).
// Each query keeps its k best keys on chip as a sorted list spread over the
// warp (position j * 32 + lane in register j of R, k <= 32R <= 128). One ballot a query and 32 columns compares the 32 new keys with
// the query's k-th best; the few that beat it (about k ln(m / k) after the
// first k, m the points in radius: a few hundred on a 2 mm voxel cloud at a
// 2 cm radius) are inserted one at a time, each a handful of ballots and
// shuffles. Nothing but the (B, n, k) indices reaches device memory.
//
// Bound on the H100: operations. About 11 float32 instructions a key (the
// key's 10 and its compare), 67 M keys an instance of 8,192 points: 0.022 ms
// an instance at 33.5 T instructions/s. The bytes are the cloud (16 bytes a
// point) and the indices (8k bytes a point), 3.3 MB or 1 us.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQ = 4;                      // queries a warp
constexpr int kQueries = kWarps * kQ;      // queries a block
constexpr int kTile = 2048;                // columns staged in shared memory at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;

__device__ __forceinline__ float infinity() { return __int_as_float(0x7f800000); }

// The packed key of one (query, column) pair, every operation rounded as the
// plain route rounds it.
__device__ __forceinline__ float packed_key(float qx, float qy, float qz, float qsq, float4 c,
                                            float r2, float scale, float nf, float colf) {
  const float cross = __fmaf_rn(qz, c.z, __fmaf_rn(qy, c.y, __fmul_rn(qx, c.x)));
  const float d2 = __fmaf_rn(-2.0f, cross, __fadd_rn(qsq, c.w));   // 2 * cross is exact
  const float level = rintf(__fmul_rn(fminf(fmaxf(d2, 0.0f), r2), scale));
  return __fmaf_rn(level, nf, colf);                               // exact: below 2^24
}

// Insert `c` (smaller than the list's k-th key) into the warp's sorted list.
template <int R>
__device__ __forceinline__ void insert(float (&list)[R], float c, int lane) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) pos += __popc(__ballot_sync(kFull, list[j] < c));
  float up[R], last[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    up[j] = __shfl_up_sync(kFull, list[j], 1);
    last[j] = __shfl_sync(kFull, list[j], 31);
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int p = j * 32 + lane;
    const float shifted = lane == 0 ? (j == 0 ? c : last[j > 0 ? j - 1 : 0]) : up[j];
    list[j] = p < pos ? list[j] : (p == pos ? c : shifted);
  }
}

// The list's key at position k - 1 (register kj, lane kl), on every lane.
template <int R>
__device__ __forceinline__ float kth(const float (&list)[R], int kj, int kl) {
  float v = list[0];
#pragma unroll
  for (int j = 1; j < R; ++j) v = kj == j ? list[j] : v;
  return __shfl_sync(kFull, v, kl);
}

template <int R>
__global__ void __launch_bounds__(kThreads, R < 4 ? 4 : 3)
knn_select_kernel(const float* __restrict__ pts, const float* __restrict__ sq,
                  long long* __restrict__ out, int n, int k, int tiles, float r2, float scale) {
  __shared__ float4 cols[kTile];
  const int b = blockIdx.x / tiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = (blockIdx.x - b * tiles) * kQueries + warp * kQ;
  const float* cloud = pts + 3LL * b * n;
  const float* norms = sq + 1LL * b * n;
  const float nf = static_cast<float>(n);
  const int kj = (k - 1) >> 5, kl = (k - 1) & 31;

  float qx[kQ], qy[kQ], qz[kQ], qs[kQ], thr[kQ], list[kQ][R];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = min(first + q, n - 1);   // a query past the cloud's end is made and dropped
    qx[q] = cloud[3 * i];
    qy[q] = cloud[3 * i + 1];
    qz[q] = cloud[3 * i + 2];
    qs[q] = norms[i];
    thr[q] = infinity();
#pragma unroll
    for (int j = 0; j < R; ++j) list[q][j] = infinity();
  }

  for (int base = 0; base < n; base += kTile) {
    const int count = min(kTile, n - base);
    __syncthreads();   // the previous tile is read
    for (int c = threadIdx.x; c < count; c += kThreads) {
      const float* p = cloud + 3 * (base + c);
      cols[c] = make_float4(p[0], p[1], p[2], norms[base + c]);
    }
    __syncthreads();
    for (int g = 0; g < count; g += 32) {
      const int c = g + lane;
      const bool inside = c < count;
      const float4 v = cols[inside ? c : 0];
      const float colf = static_cast<float>(base + c);
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float key = inside ? packed_key(qx[q], qy[q], qz[q], qs[q], v, r2, scale, nf, colf)
                                 : infinity();
        unsigned hits = __ballot_sync(kFull, key < thr[q]);
        while (hits) {   // warp-uniform: lanes in column order
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const float cand = __shfl_sync(kFull, key, src);
          if (cand < thr[q]) {
            insert<R>(list[q], cand, lane);
            thr[q] = kth<R>(list[q], kj, kl);
          }
        }
      }
    }
  }

  const unsigned un = static_cast<unsigned>(n);
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int i = first + q;
    if (i >= n) continue;
    long long* row = out + (1LL * b * n + i) * k;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int p = j * 32 + lane;
      if (p < k) row[p] = static_cast<long long>(__float2uint_rn(list[q][j]) % un);
    }
  }
}

template <int R>
int launch(const float* pts, const float* sq, long long* out, int b, int n, int k, float r2,
           float scale, cudaStream_t stream) {
  const int tiles = (n + kQueries - 1) / kQueries;
  const long long blocks = 1LL * b * tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  knn_select_kernel<R><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      pts, sq, out, n, k, tiles, r2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (b, n, k) int64 = the columns of each query's k smallest packed keys
// over its own cloud, nearest first; pts (b, n, 3) and sq (b, n) float32,
// contiguous. 1 <= k <= min(n, 128). Returns the launch's cudaError.
extern "C" int cppf2_knn_select(const void* pts, const void* sq, void* out, int b, int n, int k,
                                float r2, float scale, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k > kMaxK || k > n) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(pts);
  const float* s = static_cast<const float*>(sq);
  long long* o = static_cast<long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(p, s, o, b, n, k, r2, scale, st);
    case 2: return launch<2>(p, s, o, b, n, k, r2, scale, st);
    case 3: return launch<3>(p, s, o, b, n, k, r2, scale, st);
    default: return launch<4>(p, s, o, b, n, k, r2, scale, st);
  }
}
