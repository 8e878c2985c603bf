// Multi-head attention forward for the DINOv2 ViT, hand-written for sm_90a.
//
// Replaces the Pallas TPU kernel cppf2_tpu/ops/pallas_attention.py::_mha_kernel
// (pallas_call at :89). Same function: q (pre-scaled by 1/sqrt(hd)), k, v are
// (b, h, T, 64) bf16, b images of h heads each; logits are f32; keys at or beyond t_real are masked out;
// exp(logits - max) is rounded to bf16 before the PV product, which
// accumulates in f32; the output is divided by the f32 row sum at the end.
//
// Design. The TPU kernel keeps a head's whole K/V in VMEM and makes one pass.
// A Hopper block has at most 227 KB of shared memory, so this kernel streams
// K/V through shared memory in 128-key tiles with an online softmax (flash
// style): a running max and a running f32 sum per query row, and the f32
// output accumulator rescaled when the max grows.
//   * One block is one warpgroup (4 warps) that owns 64 query rows of one head.
//     Both products are wgmma.mma_async: S = Q K^T as m64n128k16 with Q and
//     K read from shared memory (K-major, 128-byte swizzle); O += P V as
//     m64n64k16 with P, rounded to bf16, as the register A operand and V read
//     from shared memory as it lies in memory (MN-major B): no transposed copy
//     of V exists anywhere.
//   * Q, K and V tiles arrive by TMA (cp.async.bulk.tensor on a 4-D tensor map
//     over (b, h, T, 64) with the 128-byte swizzle that wgmma reads), completion
//     on an mbarrier. Two K/V stages: while tile i is multiplied, tile i + 1
//     is in flight or has landed; tile i + 2 is requested as soon as the
//     warpgroup has left tile i. TMA fills rows past T with zeros, head by
//     head, so the loads have no bounds branch; the t_real mask on the logits
//     stays. The maps take a stride per axis, so q, k and v may be views: the
//     heads of a (b, T, 3 * h * 64) projection are read in place, although the
//     image stride there is no multiple of the head stride (which is why the
//     map has an image axis of its own and the heads are not flattened).
//   * The softmax works in base 2: exp(s - m) = exp2(s * log2e - m * log2e),
//     one FFMA and one ex2.approx per logit. The row sum takes P before its
//     bf16 rounding and the division comes after PV, as in the TPU kernel.
//   * Several blocks are resident per SM (launch bounds), so one block's
//     softmax overlaps another's products. At T = 1025 the grid is 17 x 16 =
//     272 blocks, all resident at once on 132 SMs; the 16 blocks that own the
//     one ragged query row run beside the full ones.
//
// Bound on the H100 at the ViT-L stride-8 shape (h 16, T 1025, hd 64): 4*h*T*T*hd
// = 4.3 GFLOP per call against 8.4 MB of q/k/v/o traffic, so the tensor-core
// rate bounds it (about 4.4 us at 989 TFLOP/s bf16). Short of that bound the
// kernel is held by the exponentials (16 per clock and SM, as long as the
// products themselves) and by the barriers between a tile's two products.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;
constexpr int kBq = 64;
constexpr int kBk = 128;  // keys per K/V tile; the S product below is written for 128
constexpr int kStages = 2;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;                   // resident blocks per SM
constexpr int kRowBytes = kHd * 2;              // one row = one 128-byte swizzle span
constexpr int kQBytes = kBq * kRowBytes;
constexpr int kTileBytes = kBk * kRowBytes;
constexpr int kSmemBytes = kQBytes + kStages * 2 * kTileBytes + 1024;  // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One (rows x 64) box at (row, head, image) of a (b, h, T, 64) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row, int head,
                                         int image, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(head), "r"(image)
      : "memory");
}

// Shared-memory matrix descriptor of a tile of 128-byte rows under the 128-byte
// swizzle: groups of 8 rows lie 1024 bytes apart (the stride offset); the
// leading offset is not used for a tile one swizzle span wide.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving a read or write of `x` across an asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define CPPF2_F8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) = or += A (64 x 16, shared, K-major) * B^T (128 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CPPF2_F8(d, 0), CPPF2_F8(d, 8), CPPF2_F8(d, 16), CPPF2_F8(d, 24), CPPF2_F8(d, 32),
        CPPF2_F8(d, 40), CPPF2_F8(d, 48), CPPF2_F8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major: B as it lies
// in memory, 16 rows of 64 contiguous values)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CPPF2_F8(d, 0), CPPF2_F8(d, 8), CPPF2_F8(d, 16), CPPF2_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mha_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, OutT* __restrict__ o, int T, int t_real) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // K/V stage s at [s], Q at [kStages]

  // the swizzle is a function of the address: tiles start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + kQBytes;  // stage s: K at kv_s + s * 2 * kTileBytes, V after it
  const uint32_t bar0 = smem_u32(bars);
  const uint32_t bar_q = bar0 + 8 * kStages;

  const int head = blockIdx.y;
  const int image = blockIdx.z;
  const int q0 = blockIdx.x * kBq;
  const int n_tiles = (t_real + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s <= kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, kQBytes);
    tma_load(q_s, &q_map, q0, head, image, bar_q);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (s < n_tiles) {
        mbar_expect_tx(bar0 + 8 * s, 2 * kTileBytes);
        tma_load(kv_s + s * 2 * kTileBytes, &k_map, s * kBk, head, image, bar0 + 8 * s);
        tma_load(kv_s + s * 2 * kTileBytes + kTileBytes, &v_map, s * kBk, head, image,
                 bar0 + 8 * s);
      }
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (rows r0, r1)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums
  float acc[32];                         // acc[4n + {0,1}]: row r0, cols 8n + 2t + {0,1}; {2,3}: r1
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  const uint64_t q_desc = smem_desc(q_s);
  mbar_wait(bar_q, 0);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kStages;
    const uint32_t k_s = kv_s + stage * 2 * kTileBytes;
    const uint32_t bar = bar0 + 8 * stage;
    mbar_wait(bar, (tile / kStages) & 1);

    // S = Q K^T: 4 steps of 16 along hd, each 32 bytes further into the 128-byte rows
    float s[kBk / 2];
    const uint64_t k_desc = smem_desc(k_s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) wgmma_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
    wgmma_commit_and_wait();
    pin(s);

    // key mask (only the last tile can hold keys at or beyond t_real) and the new row max
    const int kb = tile * kBk;
    if (kb + kBk > t_real) {
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        const int col = kb + n * 8 + t * 2;
        if (col >= t_real) { s[4 * n] = -INFINITY; s[4 * n + 2] = -INFINITY; }
        if (col + 1 >= t_real) { s[4 * n + 1] = -INFINITY; s[4 * n + 3] = -INFINITY; }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // tile 0 always holds key 0 < t_real, so mx is finite from the first tile on
    const float alpha0 = exp2_approx((m0 - mx0) * kLog2e);
    const float alpha1 = exp2_approx((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    const float b0 = mx0 * kLog2e, b1 = mx1 * kLog2e;
    l0 *= alpha0;
    l1 *= alpha1;
    uint32_t p[kBk / 16][4];  // bf16(P) as the A fragments of the second product
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
      const float e0 = exp2_approx(fmaf(s[4 * n], kLog2e, -b0));
      const float e1 = exp2_approx(fmaf(s[4 * n + 1], kLog2e, -b0));
      const float e2 = exp2_approx(fmaf(s[4 * n + 2], kLog2e, -b1));
      const float e3 = exp2_approx(fmaf(s[4 * n + 3], kLog2e, -b1));
      l0 += e0 + e1;  // the sum takes P before its bf16 rounding
      l1 += e2 + e3;
      p[n / 2][(n & 1) * 2] = pack_bf16(e0, e1);
      p[n / 2][(n & 1) * 2 + 1] = pack_bf16(e2, e3);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[4 * n] *= alpha0; acc[4 * n + 1] *= alpha0;
      acc[4 * n + 2] *= alpha1; acc[4 * n + 3] *= alpha1;
    }

    // O += bf16(P) V: steps of 16 keys, each 16 rows (2048 bytes) further into the V tile
    const uint64_t v_desc = smem_desc(k_s + kTileBytes);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) wgmma_rs(acc, p[kk], v_desc + kk * (16 * kRowBytes >> 4));
    wgmma_commit_and_wait();
    pin(acc);

    // every warp has left this stage: ask for the tile after next
    __syncthreads();
    if (threadIdx.x == 0 && tile + kStages < n_tiles) {
      const int row = (tile + kStages) * kBk;
      mbar_expect_tx(bar, 2 * kTileBytes);
      tma_load(k_s, &k_map, row, head, image, bar);
      tma_load(k_s + kTileBytes, &v_map, row, head, image, bar);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  OutT* oh = o + (static_cast<size_t>(image) * gridDim.y + head) * T * kHd;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t * 2;
    if (r0 < T) store2(oh + static_cast<size_t>(r0) * kHd + c, acc[4 * n] / l0, acc[4 * n + 1] / l0);
    if (r1 < T) store2(oh + static_cast<size_t>(r1) * kHd + c, acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so that nothing links against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map over x viewed as (b, h, T, 64) bf16 with the given strides of its
// image, head and row axes (in elements; the last axis is contiguous), boxes
// of `rows` x 64, 128-byte swizzle, zeros past the end of every axis.
CUresult make_map(CUtensorMap* map, const void* x, int b, int h, int T, const long long* stride,
                  int rows) {
  const cuuint64_t dims[4] = {kHd, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride[2]) * 2,
                                 static_cast<cuuint64_t>(stride[1]) * 2,
                                 static_cast<cuuint64_t>(stride[0]) * 2};
  const cuuint32_t box[4] = {kHd, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename OutT>
int launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o, int b,
           int h, int T, int t_real, cudaStream_t st) {
  // more than 48 KB of dynamic shared memory: allowed once per kernel and device
  static bool allowed[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        mha_fwd_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  const dim3 grid((T + kBq - 1) / kBq, h, b);
  mha_fwd_kernel<OutT><<<grid, kThreads, kSmemBytes, st>>>(qm, km, vm, static_cast<OutT*>(o), T,
                                                          t_real);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (b, h, T, 64) bf16 with a contiguous last axis, 16-byte aligned,
// b at most 65535; `strides` holds the image, head and row strides of q, then
// of k, then of v (in elements, each a multiple of 8); o: (b, h, T, 64)
// contiguous, bf16 (out_f32 = 0) or f32 (out_f32 = 1). Returns 0, the cudaError of the
// launch, or 100000 + the CUresult of a tensor map that could not be made
// (100000 alone: libcuda offers no cuTensorMapEncodeTiled).
extern "C" int cppf2_mha_fwd(const void* q, const void* k, const void* v, void* o, int b, int h,
                             int T, int t_real, int out_f32, const long long* strides,
                             void* stream) {
  if (encode_tiled() == nullptr) return 100000;
  CUtensorMap qm, km, vm;
  CUresult res = make_map(&qm, q, b, h, T, strides, kBq);
  if (res == CUDA_SUCCESS) res = make_map(&km, k, b, h, T, strides + 3, kBk);
  if (res == CUDA_SUCCESS) res = make_map(&vm, v, b, h, T, strides + 6, kBk);
  if (res != CUDA_SUCCESS) return 100000 + static_cast<int>(res);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch<float>(qm, km, vm, o, b, h, T, t_real, st)
                 : launch<__nv_bfloat16>(qm, km, vm, o, b, h, T, t_real, st);
}
