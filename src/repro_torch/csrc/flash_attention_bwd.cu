// Flash-attention backward for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` of
// src/repro/kernels/flash_attention.py (launched by `_bwd_call`).  They are
// the FlashAttention-2 backward: with P = exp(s - lse) recomputed from the
// forward's fp32 logsumexp (masked entries are 0) and delta = rowsum(dO * O)
// computed outside the kernels by the caller,
//
//     dV_j = sum_i P_ij dO_i             dS_ij = P_ij (dO_i . V_j - delta_i)
//     dQ_i = scale sum_j dS_ij K_j       dK_j  = scale sum_i dS_ij Q_i
//
// Two kernels, as on the TPU: `dq` owns a query tile and walks the K/V tiles
// in its causal/window horizon; `dkv` owns a key tile of one kv head and walks
// the query tiles of every query head of its GQA group.  Each output element
// is written by exactly one block, so no atomics are needed and the result is
// deterministic.  Sums run in fp32 registers and are rounded once at the write.
//
// What bounds them on the H100: at the training shape (B 4, S 512, 16 heads of
// 128, bf16, causal) dq does 3 and dkv 4 products of the forward's size,
// ~6.5 and ~8.7 us at the bf16 tensor-core peak, against 42 MB (dq) and 51 MB
// (dkv) of inputs and outputs, 12.6 and 15.1 us at 3.35 TB/s: bound by memory
// with tensor cores.  This first version, like the forward, runs the products
// on the CUDA cores in fp32, so it is bound by operations and shared-memory
// traffic instead.  What the design keeps: every tile is read from device
// memory once per visit and staged in shared memory as fp32, the S x S
// matrices never leave the block, and only the tiles inside the horizon are
// visited (the TPU kernels' [lo, hi) bounds).  Tensor cores (mma.sync or
// wgmma), TMA and pipelined tiles come later.
//
// Layout: one block of 256 threads (8 warps).  In `dq` each warp owns 8 query
// rows and a lane the logits of its rows against keys `lane` and `lane + 32`,
// then output columns `lane + 32 c` of dQ.  In `dkv` each warp owns 8 keys and
// a lane their logits against queries `lane` and `lane + 32`, then columns
// `lane + 32 c` of dK and dV.  Rows and keys past S (a ragged sequence) load as
// zeros and are masked.  Strides are in elements for the batch, head and
// sequence axes (the last axis is contiguous); every row starts on a 16-byte
// boundary, which the Python wrapper checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 8;                // rows (queries or keys) per warp

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;                    // (B, Hq, S) contiguous
  const float* delta;                  // (B, Hq, S) contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hkv, S;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;          // dO
  long long a_sb, a_sh, a_ss;          // dq, or dk
  long long c_sb, c_sh, c_ss;          // dv (dkv only)
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return qpos < p.S && kpos < p.S && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// dQ: one block per (query tile, q head, batch)
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem_bytes() {
  // Q (scaled) and dO: [64][D]; K and V: [64][D + 4]; dS: [64][64]
  return (2 * BQ * D + 2 * BK * (D + 4) + BQ * BK) * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LDK = D + 4;           // padded: conflict-free 16-byte reads
  constexpr int DPL = D / 32;          // output columns per lane

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * D;
  float* Ks = dOs + BQ * D;
  float* Vs = Ks + BK * LDK;
  float* dSs = Vs + BK * LDK;

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
  const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row_base = ((long long)b * p.Hq + h) * p.S;

  load_tile<T, D, D>(Qs, qg, p.q_ss, q0, p.S, p.scale);
  load_tile<T, D, D>(dOs, og, p.o_ss, q0, p.S, 1.f);

  float lse[ROWS], delta[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    lse[r] = row < p.S ? p.lse[row_base + row] : 0.f;
    delta[r] = row < p.S ? p.delta[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // the TPU kernel's tile range [lo, hi) (flash_attention.py:133-140)
  const int nkb = (p.S + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + BQ + BK - 1) / BK, nkb) : nkb;
  const int lo = p.window > 0 ? max(floor_div(q0 - p.window + 1, BK), 0) : 0;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // every warp is done with the last K, V
    load_tile<T, D, LDK>(Ks, kg, p.k_ss, k0, p.S, 1.f);
    load_tile<T, D, LDK>(Vs, vg, p.v_ss, k0, p.S, 1.f);
    __syncthreads();

    // s = (scale Q) K^T and dp = dO V^T for this warp's rows against keys
    // lane and lane + 32
    float s[ROWS][2], dp[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * LDK + d);
      const float4 kb = *reinterpret_cast<const float4*>(Ks + (lane + 32) * LDK + d);
      const float4 va = *reinterpret_cast<const float4*>(Vs + lane * LDK + d);
      const float4 vb = *reinterpret_cast<const float4*>(Vs + (lane + 32) * LDK + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * D + d);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + (r0 + r) * D + d);
        s[r][0] = dot4(qv, ka, s[r][0]);
        s[r][1] = dot4(qv, kb, s[r][1]);
        dp[r][0] = dot4(ov, va, dp[r][0]);
        dp[r][1] = dot4(ov, vb, dp[r][1]);
      }
    }

    // dS = P (dp - delta), P recomputed from lse; this warp's rows only
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        const float pr = visible(p, qpos, kpos) ? expf(s[r][c] - lse[r]) : 0.f;
        dSs[(r0 + r) * BK + lane + 32 * c] = pr * (dp[r][c] - delta[r]);
      }
    }
    __syncwarp();

    // acc += dS K
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        ds[r] = *reinterpret_cast<const float4*>(dSs + (r0 + r) * BK + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kk[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) kk[c] = Ks[(j + jj) * LDK + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float w = comp(ds[r], jj);
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(w, kk[c], acc[r][c]);
        }
      }
    }
    __syncwarp();                      // dS rows are rewritten next tile
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.a_sb + h * p.a_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      dqg[row * p.a_ss + lane + 32 * c] = Chunk<T>::from_float(acc[r][c] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (key tile, kv head, batch), summed over the GQA group
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_bytes() {
  // K and V: [64][D]; Q (scaled) and dO: [64][D + 4]; P^T and dS^T: [64][64];
  // lse and delta of the query tile: [64] each
  return (2 * BK * D + 2 * BQ * (D + 4) + 2 * BK * BQ + 2 * BQ) *
         (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LDQ = D + 4;
  constexpr int DPL = D / 32;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * D;
  float* Qs = Vs + BK * D;
  float* dOs = Qs + BQ * LDQ;
  float* Pt = dOs + BQ * LDQ;
  float* dSt = Pt + BK * BQ;
  float* Ls = dSt + BK * BQ;
  float* Dl = Ls + BQ;

  const int kt = blockIdx.x;           // causal: the longest query walks first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<T, D, D>(Ks, kg, p.k_ss, k0, p.S, 1.f);
  load_tile<T, D, D>(Vs, vg, p.v_ss, k0, p.S, 1.f);

  float dk[ROWS][DPL], dv[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk[r][c] = dv[r][c] = 0.f;
  }

  // the TPU kernel's query-tile range [lo, hi) (flash_attention.py:176-186)
  const int nqb = (p.S + BQ - 1) / BQ;
  const int lo = p.causal ? k0 / BQ : 0;
  const int hi = p.window > 0 ? min((k0 + BK + p.window - 2) / BQ + 1, nqb)
                              : nqb;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* og = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long row_base = ((long long)b * p.Hq + h) * p.S;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * BQ;
      __syncthreads();                 // every warp is done with the last tile
      load_tile<T, D, LDQ>(Qs, qg, p.q_ss, q0, p.S, p.scale);
      load_tile<T, D, LDQ>(dOs, og, p.o_ss, q0, p.S, 1.f);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < p.S ? p.lse[row_base + row] : 0.f;
        Dl[threadIdx.x] = row < p.S ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // s^T = K (scale Q)^T and dp^T = V dO^T for this warp's keys against
      // queries lane and lane + 32
      float s[ROWS][2], dp[ROWS][2];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(Qs + lane * LDQ + d);
        const float4 qb = *reinterpret_cast<const float4*>(Qs + (lane + 32) * LDQ + d);
        const float4 oa = *reinterpret_cast<const float4*>(dOs + lane * LDQ + d);
        const float4 ob = *reinterpret_cast<const float4*>(dOs + (lane + 32) * LDQ + d);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (r0 + r) * D + d);
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (r0 + r) * D + d);
          s[r][0] = dot4(kv, qa, s[r][0]);
          s[r][1] = dot4(kv, qb, s[r][1]);
          dp[r][0] = dot4(vv, oa, dp[r][0]);
          dp[r][1] = dot4(vv, ob, dp[r][1]);
        }
      }

#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = lane + 32 * c;
        const float l = Ls[qi];
        const float dl = Dl[qi];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int kpos = k0 + r0 + r;
          const float pr = visible(p, q0 + qi, kpos) ? expf(s[r][c] - l) : 0.f;
          Pt[(r0 + r) * BQ + qi] = pr;
          dSt[(r0 + r) * BQ + qi] = pr * (dp[r][c] - dl);
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T (scale Q)
#pragma unroll 1
      for (int j = 0; j < BQ; j += 4) {
        float4 pr[ROWS], ds[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          pr[r] = *reinterpret_cast<const float4*>(Pt + (r0 + r) * BQ + j);
          ds[r] = *reinterpret_cast<const float4*>(dSt + (r0 + r) * BQ + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float oo[DPL], qq[DPL];
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            oo[c] = dOs[(j + jj) * LDQ + lane + 32 * c];
            qq[c] = Qs[(j + jj) * LDQ + lane + 32 * c];
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float pw = comp(pr[r], jj);
            const float dw = comp(ds[r], jj);
#pragma unroll
            for (int c = 0; c < DPL; ++c) {
              dv[r][c] = fmaf(pw, oo[c], dv[r][c]);
              dk[r][c] = fmaf(dw, qq[c], dk[r][c]);
            }
          }
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.a_sb + hk * p.a_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.c_sb + hk * p.c_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = k0 + r0 + r;
    if (row >= p.S) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dkg[row * p.a_ss + lane + 32 * c] = Chunk<T>::from_float(dk[r][c]);
      dvg[row * p.c_ss + lane + 32 * c] = Chunk<T>::from_float(dv[r][c]);
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Shared memory above 48 KB has to be allowed once per kernel instance and
// device before the first launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<D>();
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<D>();
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BK - 1) / BK, p.Hkv, p.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 32: return dkv ? launch_dkv<T, 32>(p, stream) : launch_dq<T, 32>(p, stream);
    case 64: return dkv ? launch_dkv<T, 64>(p, stream) : launch_dq<T, 64>(p, stream);
    case 128: return dkv ? launch_dkv<T, 128>(p, stream) : launch_dq<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int dtype, int D, bool dkv, void* stream) {
  if (p.B <= 0 || p.Hq <= 0 || p.Hkv <= 0 || p.S <= 0 || p.Hq % p.Hkv != 0 ||
      p.B > 65535 || p.Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(p, D, dkv, s);
    case 1: return (int)dispatch<__nv_bfloat16>(p, D, dkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse and delta
// are contiguous (B, Hq, S) fp32.  Each returns the cudaError_t of its launch
// (0 on success); nothing is synchronised.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int dtype, int B, int Hq, int Hkv, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    int causal, int window, float scale, void* stream) {
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Hq, Hkv, S,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss, 0, 0, 0,
           causal, window, scale};
  return run(p, dtype, D, false, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int dtype, int B, int Hq, int Hkv, int S, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, S,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
           causal, window, scale};
  return run(p, dtype, D, true, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
