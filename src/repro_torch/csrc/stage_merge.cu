// CheckFree stage merge for Hopper (sm_90a): one multi-tensor launch per stage.
//
// Replaces the TPU kernel `_merge_kernel` of src/repro/kernels/stage_merge.py
// (launched by `stage_merge_flat`): out = ca * x + cb * y in fp32, rounded to
// the dtype of x, Alg. 1 line 3 with the normalisation folded into (ca, cb).
// The JAX code calls that kernel once per leaf of the stage
// (src/repro/core/recovery.py:36), and pads each leaf to (8, 1024) tiles for
// the TPU's vector unit.  Here one launch merges every leaf of a stage: the
// wrapper passes a table of (x, y, out, n) for up to MAX_LEAVES leaves as the
// kernel's argument, and grid row `blockIdx.y` walks leaf `blockIdx.y` with a
// grid-stride loop.  No padding and no copy: leaves are contiguous slices of
// the stacked tower, and the merged values go straight into the failed
// stage's slice.
//
// What bounds it on the H100: memory.  Each fp32 element moves 12 bytes (two
// reads, one write) for two multiplies and an add, ~0.17 operations a byte
// against the card's ~20 fp32 operations a byte.  One 4-layer stage of
// paper-llama-1.5b is 202,391,552 elements in 9 leaves, 2.43 GB, 0.725 ms at
// 3.35 TB/s.  What the design does about it: 16-byte vector loads and stores
// where all three pointers are 16-byte aligned (a scalar loop for the tail and
// for misaligned leaves), consecutive threads on consecutive addresses, and a
// grid of at most 1024 blocks per leaf so that every SM keeps many loads in
// flight.  The weights (ca, cb) stay on the device (a 2-element fp32 tensor),
// so a merge needs no copy to the host.
//
// Arithmetic: the product and the sum are rounded separately (no fused
// multiply-add), as the plain PyTorch version computes them, so the kernel
// agrees with it bit for bit in fp32, and in bf16 after the same rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 32;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_PER_LEAF = 1024;

struct Leaf {
  const void* x;
  const void* y;
  void* out;
  long long n;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
};

__device__ __forceinline__ float merge1(float ca, float x, float cb, float y) {
  return __fadd_rn(__fmul_rn(ca, x), __fmul_rn(cb, y));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void merge(const float* x, const float* y, float* out,
                               float ca, float cb) {
    const float4 a = *reinterpret_cast<const float4*>(x);
    const float4 b = *reinterpret_cast<const float4*>(y);
    *reinterpret_cast<float4*>(out) =
        make_float4(merge1(ca, a.x, cb, b.x), merge1(ca, a.y, cb, b.y),
                    merge1(ca, a.z, cb, b.z), merge1(ca, a.w, cb, b.w));
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void merge(const __nv_bfloat16* x, const __nv_bfloat16* y,
                               __nv_bfloat16* out, float ca, float cb) {
    const uint4 a = *reinterpret_cast<const uint4*>(x);
    const uint4 b = *reinterpret_cast<const uint4*>(y);
    const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&b);
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(ah[i]);
      const float2 fb = __bfloat1622float2(bh[i]);
      oh[i] = __floats2bfloat162_rn(merge1(ca, fa.x, cb, fb.x),
                                    merge1(ca, fa.y, cb, fb.y));
    }
    *reinterpret_cast<uint4*>(out) = o;
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16_rn(x); }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
stage_merge_kernel(const Table table, const float* __restrict__ w) {
  const Leaf leaf = table.leaf[blockIdx.y];
  const T* x = static_cast<const T*>(leaf.x);
  const T* y = static_cast<const T*>(leaf.y);
  T* out = static_cast<T*>(leaf.out);
  const float ca = w[0];
  const float cb = w[1];
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;

  constexpr int N = Vec<T>::N;
  const bool vec = aligned16(x) && aligned16(y) && aligned16(out);
  const long long nvec = vec ? leaf.n / N : 0;
  for (long long i = first; i < nvec; i += stride)
    Vec<T>::merge(x + i * N, y + i * N, out + i * N, ca, cb);
  for (long long i = nvec * N + first; i < leaf.n; i += stride)
    out[i] = Vec<T>::from_float(
        merge1(ca, Vec<T>::to_float(x[i]), cb, Vec<T>::to_float(y[i])));
}

}  // namespace

// table: `count` rows of (x, y, out, n) as 64-bit integers (pointers and
// element counts), host memory; w: device pointer to fp32 (ca, cb).
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success); nothing is synchronised.
extern "C" int stage_merge(const long long* table, int count, const float* w,
                           int dtype, void* stream) {
  if (count <= 0 || count > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Table t = {};
  long long most = 0;
  for (int i = 0; i < count; ++i) {
    t.leaf[i].x = reinterpret_cast<const void*>(table[4 * i]);
    t.leaf[i].y = reinterpret_cast<const void*>(table[4 * i + 1]);
    t.leaf[i].out = reinterpret_cast<void*>(table[4 * i + 2]);
    t.leaf[i].n = table[4 * i + 3];
    if (t.leaf[i].n < 0) return (int)cudaErrorInvalidValue;
    most = t.leaf[i].n > most ? t.leaf[i].n : most;
  }
  const int per_block = THREADS * (dtype == 0 ? 4 : 8);
  long long blocks = (most + per_block - 1) / per_block;
  blocks = blocks < 1 ? 1 : (blocks > MAX_BLOCKS_PER_LEAF ? MAX_BLOCKS_PER_LEAF : blocks);
  const dim3 grid((unsigned)blocks, count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: stage_merge_kernel<float><<<grid, THREADS, 0, s>>>(t, w); break;
    case 1: stage_merge_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(t, w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
