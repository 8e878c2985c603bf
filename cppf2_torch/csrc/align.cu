// The alignment's whole Adam loop in one launch, hand-written for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves this loop to XLA
// (cppf2_tpu/infer/alignment.py::align_pose, a lax.fori_loop over jax.grad).
// It replaces the port's plain loop on the card (infer/alignment.py::
// align_pose_plain), which a captured program records as some thirty small
// kernels a step, a float32 cuBLAS GEMM on CUDA cores among them (the
// backward of (p - t) @ R' with respect to R'), 100 steps in a row.
//
// What it computes, for each row b (one (instance, branch) pair): the L1 loss
//   L(t, q) = sum_i w_i |(p_i - t) R' - pred_i| / (denom * 6),  R' = Q(q) R0,
// over the row's 2K kept pair points p_i (pair i / 2, end i % 2), with
// w_i = [pair_weight > 0], denom = max(sum of the K pair weights, 1), Q the
// rotation of the normalised (x, y, z, w) quaternion q; under up_sym only the
// up_axis column enters and the divisor is denom * 2. Adam (optax's b1 0.9,
// b2 0.999, eps 1e-8, bias corrections) runs `steps` steps from t = t0,
// q = (0, 0, 0, 1), with the quaternion's gradient scaled by pi / 180. The
// launch writes R' (b, 3, 3), t (b, 3) and the final loss (b,).
//
// The gradient by hand. With G_i = sign(canon_i - pred_i) w_i / divisor
// (sign 0 at 0, as autograd's abs backward gives), each step needs 12 sums a
// row: M = sum_i (p_i - t) (x) G_i (3 x 3) and S = sum_i G_i (3). Then
// dL/dR' = M, dL/dt = -R' S, dL/dQ = M R0^T and dL/dq through
// quat_to_matrix's normalisation. The sums are taken of sign * w, which are
// -1, 0 or 1, and scaled by 1 / divisor once.
//
// Design. Each row is one thread-block cluster of C blocks (C from the
// shapes, in `plan` below: up to 8, so that B * C fills the card's SMs where
// it can). Each block gathers its slice of the row's points, predictions and
// weights once into shared memory (7 floats a point) and keeps them there for
// all steps; a slice larger than shared memory is gathered again from device
// memory (L2) every step instead. A step: every thread adds its points' 12
// products; a warp shuffle tree, then the block's warps in order, then the
// cluster's blocks in rank order through distributed shared memory sum them.
// No atomics, so a launch gives the same bits every time and in every replay.
// Every block then takes the same Adam step from the same 12 numbers in its
// thread 0 and shares t and R' through its shared memory: one cluster-wide
// exchange a step. The final loss is one more exchange.
//
// Bound on the H100. Not bytes (at K = 5,000 a row reads about 340 KB once)
// and not operations (about 45 FLOP a point a step, 45 MFLOP a row for 100
// steps, under a microsecond at 67 TFLOP/s for 16 rows): the chain of `steps`
// dependent cluster-wide reductions, each a shuffle tree, a cluster barrier,
// distributed shared memory reads and a serial Adam step, about 1-3 us each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 12;        // M (3 x 3, row-major) then S (3)
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kFields = 7;       // a staged point: p (3), pred (3), w
constexpr long long kSliceBytes = 200 * 1024;   // a block's staged slice at most

// The launch's plan for `b` rows of `n_pairs` kept pairs on a card of `sms`
// SMs: C doubles while the rows' blocks fill at most the SMs and each block
// keeps 2 points a thread, then while a block's slice exceeds kSliceBytes
// (up to kMaxCluster); a slice that still does not fit is read from device
// memory every step.
struct Plan {
  int cluster, per_block, staged;
};

Plan plan(int b, int n_pairs, int sms) {
  const long long n = 2LL * n_pairs;
  int c = 1;
  while (c < kMaxCluster && 2LL * b * c <= sms && n > 2LL * c * kThreads) c *= 2;
  while (c < kMaxCluster && (n + c - 1) / c * kFields * 4 > kSliceBytes) c *= 2;
  const long long per_block = (n + c - 1) / c;
  return {c, static_cast<int>(per_block), per_block * kFields * 4 <= kSliceBytes ? 1 : 0};
}

struct Row {
  const float* points;         // (N, 3)
  const long long* pair_idx;   // (K, 2): point index i of the row is pair_idx's flat entry i
  const float* weight;         // (K,)
  const float* pred;           // (2K, 3)
};

__device__ __forceinline__ void gather(const Row& r, int i, float p[3], float q[3], float& w) {
  const long long src = r.pair_idx[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p[c] = r.points[3 * src + c];
    q[c] = r.pred[3LL * i + c];
  }
  w = r.weight[i >> 1] > 0.f ? 1.f : 0.f;
}

// Point j of the block's slice (point lo + j of the row): from shared memory
// where the slice is staged, else gathered from device memory again.
template <bool kStaged>
__device__ __forceinline__ void point(const Row& r, const float* slice, int per_block, int lo,
                                      int j, float p[3], float q[3], float& w) {
  if (kStaged) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = slice[c * per_block + j];
      q[c] = slice[(3 + c) * per_block + j];
    }
    w = slice[6 * per_block + j];
  } else {
    gather(r, lo + j, p, q, w);
  }
}

__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// Q(q): the rotation of (x, y, z, w) normalised as q / (|q| + 1e-12).
__device__ void quat_to_matrix(const float q[4], float m[9]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]) + 1e-12f;
  const float x = q[0] / n, y = q[1] / n, z = q[2] / n, w = q[3] / n;
  m[0] = 1.f - 2.f * (y * y + z * z); m[1] = 2.f * (x * y - z * w); m[2] = 2.f * (x * z + y * w);
  m[3] = 2.f * (x * y + z * w); m[4] = 1.f - 2.f * (x * x + z * z); m[5] = 2.f * (y * z - x * w);
  m[6] = 2.f * (x * z - y * w); m[7] = 2.f * (y * z + x * w); m[8] = 1.f - 2.f * (x * x + y * y);
}

__device__ void matmul3(const float a[9], const float b[9], float out[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

// Sum every thread's v[0..N) over the cluster: a shuffle tree in each warp,
// the warps in order, then the blocks in rank order. `parity` alternates
// between consecutive calls, so that a block may write its next partials
// while another still reads its last. total[0..N) holds the sums in every
// block on return.
template <int N>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster, float v[N],
                                            float (*warp_part)[kSums], float (*block_part)[kSums],
                                            float* total, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) warp_part[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_part[w][threadIdx.x];
    block_part[parity][threadIdx.x] = s;
  }
  cluster.sync();
  if (threadIdx.x < N) {
    // every remote read issued before the first add, then added in rank order
    const int blocks = static_cast<int>(cluster.num_blocks());
    float part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      part[r] = r < blocks ? cluster.map_shared_rank(block_part[parity], r)[threadIdx.x] : 0.f;
    }
    float s = part[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) {
      if (r < blocks) s += part[r];
    }
    total[threadIdx.x] = s;
  }
  __syncthreads();
}

// One Adam step of a parameter vector, as the plain loop writes it out.
template <int N>
__device__ __forceinline__ void adam(float p[N], float m[N], float v[N], const float g[N], float lr,
                                     float bc1, float bc2) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    m[k] = 0.9f * m[k] + 0.1f * g[k];
    v[k] = 0.999f * v[k] + 0.001f * g[k] * g[k];
    p[k] = p[k] + (-lr) * ((m[k] / bc1) / (sqrtf(v[k] / bc2) + 1e-8f));
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
align_adam_kernel(const float* __restrict__ points, int n_points,
                  const long long* __restrict__ pair_idx, const float* __restrict__ pair_weight,
                  const float* __restrict__ pred, const float* __restrict__ rot0,
                  const float* __restrict__ trans0, int n_pairs, int per_block, int steps, float lr,
                  int up_sym, int up_axis, float* __restrict__ out_rot,
                  float* __restrict__ out_trans, float* __restrict__ out_loss) {
  extern __shared__ float slice[];   // kFields rows of per_block floats
  __shared__ float warp_part[kWarps][kSums];
  __shared__ float block_part[2][kSums];
  __shared__ float total[kSums];
  __shared__ float pose[12];         // t (3), R' (9) of the current step

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / static_cast<int>(cluster.num_blocks());
  const int n = 2 * n_pairs;
  const int lo = min(rank * per_block, n);
  const int count = min(lo + per_block, n) - lo;
  const Row r{points + 3LL * row * n_points, pair_idx + 2LL * row * n_pairs,
              pair_weight + static_cast<long long>(row) * n_pairs, pred + 3LL * row * n};
  float mask[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) mask[c] = (!up_sym || c == up_axis) ? 1.f : 0.f;

  // the slice into shared memory, and the row's count of kept pairs (each
  // pair's first end counts it)
  float kept[1] = {0.f};
  for (int j = threadIdx.x; j < count; j += kThreads) {
    float p[3], q[3], w;
    gather(r, lo + j, p, q, w);
    if (kStaged) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        slice[c * per_block + j] = p[c];
        slice[(3 + c) * per_block + j] = q[c];
      }
      slice[6 * per_block + j] = w;
    }
    if (((lo + j) & 1) == 0) kept[0] += w;
  }
  int parity = 0;
  cluster_sum<1>(cluster, kept, warp_part, block_part, total, parity);
  parity ^= 1;
  const float divisor = fmaxf(total[0], 1.f) * (up_sym ? 2.f : 6.f);

  // thread 0's Adam state; every block holds the same
  float r0[9], t[3], q[4] = {0.f, 0.f, 0.f, 1.f};
  float mt[3] = {0.f, 0.f, 0.f}, vt[3] = {0.f, 0.f, 0.f};
  float mq[4] = {0.f, 0.f, 0.f, 0.f}, vq[4] = {0.f, 0.f, 0.f, 0.f};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) r0[k] = rot0[9LL * row + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = trans0[3LL * row + k];
    float qm[9];
    quat_to_matrix(q, qm);
#pragma unroll
    for (int k = 0; k < 3; ++k) pose[k] = t[k];
    matmul3(qm, r0, pose + 3);
  }
  __syncthreads();

  double b1t = 1.0, b2t = 1.0;
  for (int step = 1; step <= steps; ++step) {
    float tt[3], rr[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) tt[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) rr[k] = pose[3 + k];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    for (int j = threadIdx.x; j < count; j += kThreads) {
      float p[3], pr[3], w;
      point<kStaged>(r, slice, per_block, lo, j, p, pr, w);
      const float d[3] = {p[0] - tt[0], p[1] - tt[1], p[2] - tt[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float canon = d[0] * rr[c] + d[1] * rr[3 + c] + d[2] * rr[6 + c];
        const float g = w * mask[c] * sgn(canon - pr[c]);
#pragma unroll
        for (int a = 0; a < 3; ++a) acc[3 * a + c] += d[a] * g;
        acc[9 + c] += g;
      }
    }
    cluster_sum<kSums>(cluster, acc, warp_part, block_part, total, parity);
    parity ^= 1;

    if (threadIdx.x == 0) {
      float gr[9], gt[3], gq_mat[9], gq[4];
#pragma unroll
      for (int k = 0; k < 9; ++k) gr[k] = total[k] / divisor;          // dL/dR'
#pragma unroll
      for (int a = 0; a < 3; ++a) {                                    // dL/dt = -R' S
        gt[a] = -(rr[3 * a] * (total[9] / divisor) + rr[3 * a + 1] * (total[10] / divisor) +
                  rr[3 * a + 2] * (total[11] / divisor));
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)                                      // dL/dQ = dL/dR' R0^T
#pragma unroll
        for (int j = 0; j < 3; ++j)
          gq_mat[3 * i + j] = gr[3 * i] * r0[3 * j] + gr[3 * i + 1] * r0[3 * j + 1] +
                              gr[3 * i + 2] * r0[3 * j + 2];
      // through quat_to_matrix: first to the normalised quaternion u ...
      const float rad = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
      const float nrm = rad + 1e-12f;
      const float x = q[0] / nrm, y = q[1] / nrm, z = q[2] / nrm, w = q[3] / nrm;
      const float* G = gq_mat;
      const float gu[4] = {
          2.f * y * (G[1] + G[3]) + 2.f * z * (G[2] + G[6]) - 4.f * x * (G[4] + G[8]) +
              2.f * w * (G[7] - G[5]),
          2.f * x * (G[1] + G[3]) + 2.f * z * (G[5] + G[7]) - 4.f * y * (G[0] + G[8]) +
              2.f * w * (G[2] - G[6]),
          2.f * x * (G[2] + G[6]) + 2.f * y * (G[5] + G[7]) - 4.f * z * (G[0] + G[4]) +
              2.f * w * (G[3] - G[1]),
          2.f * z * (G[3] - G[1]) + 2.f * y * (G[2] - G[6]) + 2.f * x * (G[7] - G[5])};
      // ... then through u = q / (|q| + 1e-12), and the pi / 180 scale
      const float dot = gu[0] * q[0] + gu[1] * q[1] + gu[2] * q[2] + gu[3] * q[3];
      const float scale = 0.017453292519943295f;
#pragma unroll
      for (int k = 0; k < 4; ++k) gq[k] = (gu[k] / nrm - q[k] * dot / (nrm * nrm * rad)) * scale;

      b1t *= 0.9;
      b2t *= 0.999;
      const float bc1 = static_cast<float>(1.0 - b1t), bc2 = static_cast<float>(1.0 - b2t);
      adam<3>(t, mt, vt, gt, lr, bc1, bc2);
      adam<4>(q, mq, vq, gq, lr, bc1, bc2);
      float qm[9];
      quat_to_matrix(q, qm);
#pragma unroll
      for (int k = 0; k < 3; ++k) pose[k] = t[k];
      matmul3(qm, r0, pose + 3);
    }
    __syncthreads();
  }

  // the loss at the final pose
  float loss[1] = {0.f};
  {
    float tt[3], rr[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) tt[k] = pose[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) rr[k] = pose[3 + k];
    for (int j = threadIdx.x; j < count; j += kThreads) {
      float p[3], pr[3], w;
      point<kStaged>(r, slice, per_block, lo, j, p, pr, w);
      const float d[3] = {p[0] - tt[0], p[1] - tt[1], p[2] - tt[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float canon = d[0] * rr[c] + d[1] * rr[3 + c] + d[2] * rr[6 + c];
        loss[0] += fabsf(canon - pr[c]) * w * mask[c];
      }
    }
  }
  cluster_sum<1>(cluster, loss, warp_part, block_part, total, parity);
  if (rank == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out_trans[3LL * row + k] = pose[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) out_rot[9LL * row + k] = pose[3 + k];
    out_loss[row] = total[0] / divisor;
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// The plan of a launch for `b` rows of `n_pairs` kept pairs on a card of
// `sms` SMs, into out[0..3): blocks a row, points a block, staged (1 or 0).
extern "C" int cppf2_align_plan(int b, int n_pairs, int sms, int* out) {
  if (b < 1 || n_pairs < 0 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(b, n_pairs, sms);
  out[0] = p.cluster;
  out[1] = p.per_block;
  out[2] = p.staged;
  return 0;
}

// points (b, n_points, 3) f32, pair_idx (b, n_pairs, 2) int64, pair_weight
// (b, n_pairs) f32, pred (b, n_pairs, 2, 3) f32, rot0 (b, 3, 3) f32, trans0
// (b, 3) f32, all contiguous, on the current device, whose SM count sets the
// plan. Writes out_rot (b, 3, 3), out_trans (b, 3), out_loss (b,). Returns
// the launch's cudaError.
extern "C" int cppf2_align_pose(const void* points, int n_points, const void* pair_idx,
                                const void* pair_weight, const void* pred, const void* rot0,
                                const void* trans0, int b, int n_pairs, int steps, float lr,
                                int up_sym, int up_axis, void* out_rot, void* out_trans,
                                void* out_loss, void* stream) {
  if (b < 1 || n_points < 1 || n_pairs < 0 || n_pairs >= (1 << 30) || steps < 0 ||
      up_axis < 0 || up_axis > 2 || static_cast<long long>(b) * kMaxCluster > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = plan(b, n_pairs, sms);
  auto kernel = p.staged ? align_adam_kernel<true> : align_adam_kernel<false>;
  const size_t smem = p.staged ? static_cast<size_t>(kFields) * p.per_block * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * p.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(points), n_points,
      static_cast<const long long*>(pair_idx), static_cast<const float*>(pair_weight),
      static_cast<const float*>(pred), static_cast<const float*>(rot0),
      static_cast<const float*>(trans0), n_pairs, p.per_block, steps, lr, up_sym, up_axis,
      static_cast<float*>(out_rot), static_cast<float*>(out_trans), static_cast<float*>(out_loss));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
