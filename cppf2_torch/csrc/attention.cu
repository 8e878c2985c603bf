// Multi-head attention forward for the DINOv2 ViT, hand-written for sm_90a.
//
// Replaces the Pallas TPU kernel cppf2_tpu/ops/pallas_attention.py::_mha_kernel
// (pallas_call at :89). Same function: q (pre-scaled by 1/sqrt(hd)), k, v are
// (h, T, 64) bf16; logits are f32; keys at or beyond t_real are masked out;
// exp(logits - max) is rounded to bf16 before the PV product, which
// accumulates in f32; the output is divided by the f32 row sum at the end.
//
// Design. The TPU kernel keeps a head's whole K/V in VMEM and makes one pass.
// A Hopper block has at most 227 KB of shared memory and far fewer registers
// per row, so this kernel streams K/V through shared memory in 64-key tiles
// with an online softmax (flash style): a running max and a running f32 sum
// per query row, and the f32 output accumulator rescaled when the max grows.
// One block of 4 warps owns 64 query rows of one head (16 rows per warp); the
// products run on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32
// accumulate), with P kept in registers between the two products. V is
// stored transposed in shared memory so each B fragment is one 32-bit load.
//
// Bound on the H100 at the ViT-L stride-8 shape (h 16, T 1025, hd 64): 4*h*T*T*hd
// = 4.3 GFLOP per call against 8.4 MB of q/k/v/o traffic, so the tensor-core
// rate bounds it (about 4.4 us at 989 TFLOP/s bf16). This first version has
// no TMA, no wgmma and no copy/compute overlap; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kLd = kHd + 8;  // padded row: conflict-free 32-bit fragment loads
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, OutT* __restrict__ o, int T,
               int t_real) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBk][kLd];
  __shared__ __align__(16) __nv_bfloat16 vt[kHd][kLd];  // V transposed: [dim][key]

  const size_t head_off = static_cast<size_t>(blockIdx.y) * T * kHd;
  const __nv_bfloat16* qh = q + head_off;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;
  OutT* oh = o + head_off;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = blockIdx.x * kBq + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as A fragments for the 4 k-steps of hd = 64; rows past T read as 0.
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = r0 < T ? ld32(qh + static_cast<size_t>(r0) * kHd + c) : 0u;
    qa[kk][1] = r1 < T ? ld32(qh + static_cast<size_t>(r1) * kHd + c) : 0u;
    qa[kk][2] = r0 < T ? ld32(qh + static_cast<size_t>(r0) * kHd + c + 8) : 0u;
    qa[kk][3] = r1 < T ? ld32(qh + static_cast<size_t>(r1) * kHd + c + 8) : 0u;
  }

  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows r0, r1)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (t_real + kBk - 1) / kBk;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kb = tile * kBk;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kBk * kHd / 8; i += kThreads) {
      const int row = i >> 3;
      const int c8 = (i & 7) * 8;
      const int key = kb + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(key) * kHd + c8);
        vv = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(key) * kHd + c8);
      }
      *reinterpret_cast<uint4*>(&ks[row][c8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[c8 + j][row] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + t * 2];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // key mask and the new row max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = kb + n * 8 + t * 2;
      if (col >= t_real) { s[n][0] = -INFINITY; s[n][2] = -INFINITY; }
      if (col + 1 >= t_real) { s[n][1] = -INFINITY; s[n][3] = -INFINITY; }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // tile 0 always holds key 0 < t_real, so mx is finite from the first tile
    const float alpha0 = expf(m0 - mx0);
    const float alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha0; acc[n][1] *= alpha0;
      acc[n][2] *= alpha1; acc[n][3] *= alpha1;
      s[n][0] = expf(s[n][0] - mx0); s[n][1] = expf(s[n][1] - mx0);
      s[n][2] = expf(s[n][2] - mx1); s[n][3] = expf(s[n][3] - mx1);
      l0 += s[n][0] + s[n][1];  // the sum takes P before its bf16 rounding
      l1 += s[n][2] + s[n][3];
    }

    // O += bf16(P) V: 4 k-steps of 16 keys; P's C layout is the A layout.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vr = &vt[n * 8 + g][kk * 16 + t * 2];
        mma_bf16(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < T) store2(oh + static_cast<size_t>(r0) * kHd + c, acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < T) store2(oh + static_cast<size_t>(r1) * kHd + c, acc[n][2] / l1, acc[n][3] / l1);
  }
}

}  // namespace

// q, k, v: (h, T, 64) bf16 contiguous; o: (h, T, 64) bf16 (out_f32 = 0) or
// f32 (out_f32 = 1). Returns cudaGetLastError() after the launch.
extern "C" int cppf2_mha_fwd(const void* q, const void* k, const void* v, void* o, int h,
                             int T, int t_real, int out_f32, void* stream) {
  const dim3 grid((T + kBq - 1) / kBq, h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  if (out_f32) {
    mha_fwd_kernel<float><<<grid, kThreads, 0, st>>>(qb, kb, vb, static_cast<float*>(o), T,
                                                     t_real);
  } else {
    mha_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        qb, kb, vb, static_cast<__nv_bfloat16*>(o), T, t_real);
  }
  return static_cast<int>(cudaGetLastError());
}
