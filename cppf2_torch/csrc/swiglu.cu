// The SwiGLU gate of a DINOv2 ViT-g block (kernel K5), hand-written for sm_90a.
//
// Replaces no TPU kernel: the JAX package's ViT has GELU blocks only. It was
// added for DINOv2 ViT-g/14 with registers (`models/dinov2.py`, ffn="swiglu"),
// whose feed-forward is w3(silu(a) * b) with (a, b) the two halves of w12's
// output. For an input of R rows of 2h values (a the first h of a row, b the
// last h) it writes R rows of h values:
//   out[r, j] = a[r, j] / (1 + exp(-a[r, j])) * b[r, j],
// in float32 from the input's values, rounded once to the input's type (the
// plain version's `silu(a.float()) * b.float()` and the same division and
// `expf`, so the two agree to a rounding of the last bit where they differ at
// all).
//
// Bound on the H100: 6 bytes an element in bfloat16 (a and b read once, the
// product written once) and about 20 operations, so it is bound by the HBM's
// 3.35 TB/s: at ViT-g's stride-8 crop (1029 tokens, h = 4096) 25.3 MB a block
// and 7.5 us, 0.30 ms over the 40 blocks. Written as plain PyTorch from the
// bfloat16 w12 output with the silu in float32 the gate takes about 40 bytes
// an element. Design: one thread moves 16 bytes of a, 16 of b and 16 of the
// product (8 bfloat16 values) per row, neighbouring threads on neighbouring
// addresses; grid.x covers a row's columns, grid.y the rows (and loops past
// 65535), so no thread divides an index. The wrapper (`ops/swiglu.py`)
// passes only halves that are whole 16-byte vectors at 16-byte aligned
// addresses (SwiGLU's hidden width is a multiple of 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
swiglu_gate_kernel(const T* __restrict__ in, T* __restrict__ out, long long rows, int h) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (col >= h) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const T* a_row = in + r * 2 * h;
    const Pack<T, V> a = *reinterpret_cast<const Pack<T, V>*>(a_row + col);
    const Pack<T, V> b = *reinterpret_cast<const Pack<T, V>*>(a_row + h + col);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float x = to_float(a.v[k]);
      o.v[k] = from_float<T>(x / (1.0f + expf(-x)) * to_float(b.v[k]));
    }
    *reinterpret_cast<Pack<T, V>*>(out + r * h + col) = o;
  }
}

template <typename T>
int launch(const void* in_ptr, void* out_ptr, long long rows, int h, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const T* in = static_cast<const T*>(in_ptr);
  T* out = static_cast<T*>(out_ptr);
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaSuccess);
  if (h % V != 0 || reinterpret_cast<uintptr_t>(in) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int per_row = h / V;
  const dim3 grid((per_row + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
  swiglu_gate_kernel<T, V><<<grid, kThreads, 0, stream>>>(in, out, rows, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (rows, h) = the gate of in (rows, 2h), both contiguous, of one type:
// bfloat16 (is_float 0) or float32 (is_float 1). Returns the launch's
// cudaError.
extern "C" int cppf2_swiglu_gate(const void* in, void* out, long long rows, int h, int is_float,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float ? launch<float>(in, out, rows, h, s) : launch<__nv_bfloat16>(in, out, rows, h, s);
}
