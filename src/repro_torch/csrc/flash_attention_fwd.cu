// Flash-attention forward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the TPU kernel `_flash_kernel` of src/repro/kernels/flash_attention.py
// (launched by `_fwd_call`): causal, sliding-window or full GQA attention with
// an online softmax over K/V tiles, writing `out` in the input dtype and the
// per-row `lse = m + log(l)` in fp32.  Masked logits are -1e30, the softmax is
// kept in fp32, the scale is 1/sqrt(D) and query head h reads kv head
// h / (Hq / Hkv), all as in the TPU kernel.
//
// What bounds it on the H100: at the serving shape (B 8, S 512, 16 heads of
// 128, bf16, causal) the work is ~8.6 GFLOP against ~67 MB of q/k/v/out, so
// with tensor cores the kernel would be bound by memory (~20 us).  This first
// version runs the two products on the CUDA cores in fp32 (67 TFLOP/s peak,
// not 989), so it is bound by operations and by shared-memory traffic instead.
// The design keeps what matters for both: every K/V tile is read from device
// memory once per query tile and staged in shared memory, the S x S matrix
// never leaves the block, and the tile loop visits only the tiles inside the
// causal/window horizon (the TPU kernel's [lo, hi) range).  Tensor-core
// products (mma.sync / wgmma), TMA and a pipelined K/V ring come later.
//
// Layout: one block of 256 threads per (query tile of 64 rows, q head, batch).
// Each of the 8 warps owns 8 query rows.  For the Q.K^T tile a lane computes
// the logits of its 8 rows against keys `lane` and `lane + 32`; for P.V a
// lane owns the output columns `lane + 32 c` that are below D (at D = 80,
// zamba2's head dim, lanes 0-15 own a third column and lanes 16-31 do not).  Q, K and V tiles are staged in
// shared memory as fp32 (Q pre-scaled); after the logits are taken, the K
// tile's space holds the probabilities P.  Rows and keys past S (a ragged
// prompt) are loaded as zeros and masked.  The running max, sum and output
// accumulator of each row live in registers in fp32.
//
// Strides are passed in elements for the batch, head and sequence axes (the
// last axis is contiguous), so the model's (B, S, H, D) layout needs no copy.
// Every row must start on a 16-byte boundary; the Python wrapper checks it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per K/V tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;       // query rows per warp
constexpr float NEG_INF = -1e30f;      // the TPU kernel's mask value

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Hq, Hkv, S;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;
  float scale;
};

// 16 bytes of a row -> fp32 in shared memory (times `scale`).
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* g, float* s, float scale) {
    float4 a = *reinterpret_cast<const float4*>(g);
    a.x *= scale; a.y *= scale; a.z *= scale; a.w *= scale;
    *reinterpret_cast<float4*>(s) = a;
  }
  __device__ static float from_float(float x) { return x; }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* g, float* s, float scale) {
    uint4 raw = *reinterpret_cast<const uint4*>(g);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float2 f0 = __bfloat1622float2(h[0]);
    float2 f1 = __bfloat1622float2(h[1]);
    float2 f2 = __bfloat1622float2(h[2]);
    float2 f3 = __bfloat1622float2(h[3]);
    *reinterpret_cast<float4*>(s) =
        make_float4(f0.x * scale, f0.y * scale, f1.x * scale, f1.y * scale);
    *reinterpret_cast<float4*>(s + 4) =
        make_float4(f2.x * scale, f2.y * scale, f3.x * scale, f3.y * scale);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// Stage rows [row0, row0 + 64) of one head into shared memory with leading
// dimension LD; rows at or past S become zeros.
template <typename T, int D, int LD>
__device__ void load_tile(float* smem, const T* base, long long row_stride,
                          int row0, int S, float scale) {
  constexpr int N = Chunk<T>::N;
  constexpr int CPR = D / N;           // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * N;
    float* dst = smem + r * LD + c;
    if (row0 + r < S) {
      Chunk<T>::load(base + (long long)(row0 + r) * row_stride + c, dst, scale);
    } else {
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// the K tile (leading dimension D + 4) and, once the logits are taken, P
template <int D>
__host__ __device__ constexpr int kp_floats() {
  return BK * (D + 4) > BQ * BK ? BK * (D + 4) : BQ * BK;
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * D + kp_floats<D>() + BK * D) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)   // two blocks per SM
flash_fwd_kernel(const Params p) {
  constexpr int LDK = D + 4;           // padded: conflict-free 16-byte reads
  constexpr int DPL = (D + 31) / 32;   // output columns per lane, at most

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * D;             // K tile, then P
  float* Vs = Ks + kp_floats<D>();

  const int nqt = (p.S + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x;   // longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D, D>(Qs, qg, p.q_ss, q0, p.S, p.scale);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // the TPU kernel's tile range [lo, hi) (flash_attention.py:48-57)
  const int nkb = (p.S + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + BQ + BK - 1) / BK, nkb) : nkb;
  const int lo = p.window > 0 ? max(floor_div(q0 - p.window + 1, BK), 0) : 0;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // last tile's P and V are consumed
    load_tile<T, D, LDK>(Ks, kg, p.k_ss, k0, p.S, 1.f);
    load_tile<T, D, D>(Vs, vg, p.v_ss, k0, p.S, 1.f);
    __syncthreads();

    // logits of this warp's rows against keys lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * LDK + d);
      const float4 kb = *reinterpret_cast<const float4*>(Ks + (lane + 32) * LDK + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * D + d);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kb.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kb.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kb.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kb.w, s[r][1]);
      }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + r0 + r;
      bool vis[2];
      float tmax = NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        vis[c] = kpos < p.S && (!p.causal || kpos <= qpos) &&
                 (p.window <= 0 || kpos > qpos - p.window);
        if (!vis[c]) s[r][c] = NEG_INF;
        tmax = fmaxf(tmax, s[r][c]);
      }
      const float m_new = fmaxf(m[r], warp_max(tmax));
      const float alpha = expf(m[r] - m_new);
      const float p0 = vis[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = vis[1] ? expf(s[r][1] - m_new) : 0.f;
      s[r][0] = p0;
      s[r][1] = p1;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();                   // every warp is done reading K
    float* Ps = Ks + r0 * BK;          // this warp's rows of P
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      Ps[r * BK + lane] = s[r][0];
      Ps[r * BK + lane + 32] = s[r][1];
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        pr[r] = *reinterpret_cast<const float4*>(Ps + r * BK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          vv[c] = lane + 32 * c < D ? Vs[(j + jj) * D + lane + 32 * c] : 0.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pj = jj == 0 ? pr[r].x : jj == 1 ? pr[r].y
                         : jj == 2 ? pr[r].z : pr[r].w;
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
        }
      }
    }
  }

  // out = acc / l and lse = m + log(l), as flash_attention.py:84-85
  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  float* lg = p.lse + ((long long)b * p.Hq + h) * p.S;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.S) continue;
    const float denom = l[r] + 1e-30f;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < D)
        og[row * p.o_ss + lane + 32 * c] = Chunk<T>::from_float(acc[r][c] / denom);
    if (lane == 0) lg[row] = m[r] + logf(denom);
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  // above 48 KB of shared memory, once per instance and device
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int B, int Hq, int Hkv, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 ||
      B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, lse, B, Hq, Hkv, S,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(p, D, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(p, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
