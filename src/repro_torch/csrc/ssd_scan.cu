// Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA C++ on the CUDA cores.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (launched by `ssd_scan`), and adds what the model path takes from
// `ssd_chunked` (src/repro/models/ssm.py): a starting state and the final
// state.  For each (batch, head) the sequence is cut into chunks of Q tokens;
// with cs the inclusive cumsum of the log decay a within the chunk,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) x_j + exp(cs_i) C_i . S
//   S    <- exp(cs_last) S + sum_j exp(cs_last - cs_j) x_j B_j^T
// where S is the (P, N) fp32 state carried from chunk to chunk.
//
// What bounds it on the H100: at mamba2-1.3b's serving shape (B 8, T 512,
// 64 heads of P 64, N 128, one group, bf16 x) the call moves 87 MB (x and y,
// fp32 a, B and C, the fp32 final state), 26 us at 3.35 TB/s, and does
// 15 GFLOP, 15 us at the bf16 tensor-core peak: bound by bytes.  This first
// version runs every product on the CUDA cores in fp32 (67 TFLOP/s), so it
// is bound by operations and by shared-memory reads instead; tensor-core
// products and more blocks per head come later.  What the design keeps: every
// input is read from device memory once and y and the state are written
// once; the Q x Q matrix and the state never leave the block.
//
// Layout: one block of 256 threads per (head, batch) walks the chunks in
// order, as the TPU grid's sequential chunk axis does.  Shared memory holds
// the chunk's x (Q x P), B and C transposed (N x Q, so that a 16-byte read
// gives four tokens), the masked decayed matrix transposed, the state
// transposed (N x P) and cs, all fp32: 133 KB at Q 64, P 64, N 128.  Each
// product gives every thread 4 x 4 tiles of its output, with 16-byte reads
// of both operands.  The decay exp(cs_i - cs_j) is taken only where j <= i:
// above the diagonal it can overflow to inf (a reaches -1.6 a token with
// mamba2's parameters), and multiplying inf by a 0/1 mask would give NaN.
// A ragged last chunk (T % Q != 0) is loaded as zeros with a = 0 and its
// rows past T are not written.
//
// Strides are in elements for the batch, token and head (group) axes; the
// last axis is contiguous, so B and C can be strided views of the model's
// xBC tensor.  x, B and C share a dtype (fp32 or bf16); a, the states and
// every sum are fp32; y is written in x's dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 64;
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;

struct Params {
  const void* x;
  const float* a;
  const void* bm;
  const void* cm;
  const float* init;        // (B, H, P, N) contiguous, or null for zeros
  void* y;
  float* final_state;       // (B, H, P, N) contiguous
  int B, T, H, G, P, N, chunk;
  long long x_sb, x_st, x_sh;
  long long a_sb, a_st, a_sh;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
  long long y_sb, y_st, y_sh;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// floats of shared memory for a chunk of q4 (a multiple of 4) tokens
__host__ __device__ constexpr int smem_floats(int q4, int P, int N) {
  return q4 * P                 // xs  [q4][P]
         + 2 * N * (q4 + 4)     // bt, ct  [N][q4 + 4]
         + q4 * (q4 + 4)        // att [q4][q4 + 4], att[j][i]
         + N * P                // st  [N][P], st[n][p] = S[p][n]
         + q4;                  // cs
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const Params p) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int tid = threadIdx.x;
  const int P = p.P, N = p.N;
  const int q4 = round4(p.chunk);
  const int ldq = q4 + 4;                 // padded: fewer bank conflicts

  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* bt = xs + q4 * P;
  float* ct = bt + N * ldq;
  float* att = ct + N * ldq;
  float* st = att + q4 * ldq;
  float* cs = st + N * P;

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + g * p.c_sg;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const long long sbase = ((long long)b * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS) {
    const int pp = i / N, n = i % N;
    st[n * P + pp] = p.init ? p.init[sbase + i] : 0.f;
  }

  const int nq4 = q4 / 4, np4 = P / 4, nn4 = N / 4;
  for (int t0 = 0; t0 < p.T; t0 += p.chunk) {
    const int q = min(p.chunk, p.T - t0);
    __syncthreads();                      // the last chunk's readers are done

    // ---- stage x, B^T, C^T and cs ------------------------------------
    for (int i = tid; i < q4 * P; i += THREADS) {
      const int j = i / P, pp = i % P;
      xs[i] = j < q ? to_float(xg[(long long)(t0 + j) * p.x_st + pp]) : 0.f;
    }
    for (int i = tid; i < q4 * N; i += THREADS) {
      const int j = i / N, n = i % N;
      const long long tb = (long long)(t0 + j);
      bt[n * ldq + j] = j < q ? to_float(bg[tb * p.b_st + n]) : 0.f;
      ct[n * ldq + j] = j < q ? to_float(cg[tb * p.c_st + n]) : 0.f;
    }
    if (tid < 32) {                       // inclusive cumsum of a, 2 a lane
      const int j0 = 2 * tid, j1 = j0 + 1;
      const float a0 = j0 < q ? ag[(long long)(t0 + j0) * p.a_st] : 0.f;
      const float a1 = j1 < q ? ag[(long long)(t0 + j1) * p.a_st] : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      float before = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) before = 0.f;
      if (j0 < q4) cs[j0] = before + a0;
      if (j1 < q4) cs[j1] = s;
    }
    __syncthreads();
    const float cs_last = cs[q - 1];

    // ---- att[j][i] = (C_i . B_j) exp(cs_i - cs_j) for j <= i, else 0 ---
    for (int tile = tid; tile < nq4 * nq4; tile += THREADS) {
      const int ti = tile / nq4, tj = tile % nq4;
      float acc[4][4] = {};
      if (tj <= ti) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + n * ldq + 4 * ti);
          const float4 bv = *reinterpret_cast<const float4*>(bt + n * ldq + 4 * tj);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(comp(cv, r), comp(bv, c), acc[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 4 * tj + c;
        float o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * ti + r;
          o[r] = j <= i ? acc[r][c] * expf(cs[i] - cs[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(att + j * ldq + 4 * ti) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    // ---- y = att x + exp(cs) (C S^T), the state as of the chunk's start --
    for (int tile = tid; tile < nq4 * np4; tile += THREADS) {
      const int ti = tile / np4, tp = tile % np4;
      float intra[4][4] = {}, inter[4][4] = {};
      const int jend = min(4 * ti + 4, q);
      for (int j = 0; j < jend; ++j) {
        const float4 av = *reinterpret_cast<const float4*>(att + j * ldq + 4 * ti);
        const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + 4 * tp);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            intra[r][c] = fmaf(comp(av, r), comp(xv, c), intra[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(ct + n * ldq + 4 * ti);
        const float4 sv = *reinterpret_cast<const float4*>(st + n * P + 4 * tp);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[r][c] = fmaf(comp(cv, r), comp(sv, c), inter[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ti + r;
        if (i >= q) continue;
        const float e = expf(cs[i]);
        T* row = yg + (long long)(t0 + i) * p.y_st + 4 * tp;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          row[c] = from_float<T>(intra[r][c] + e * inter[r][c]);
      }
    }
    __syncthreads();                      // S and x are read

    // ---- S <- exp(cs_last) S + (x * exp(cs_last - cs))^T B ---------------
    for (int i = tid; i < q4 * P; i += THREADS) {
      const int j = i / P;
      xs[i] *= j < q ? expf(cs_last - cs[j]) : 0.f;
    }
    __syncthreads();
    const float dq = expf(cs_last);
    for (int tile = tid; tile < nn4 * np4; tile += THREADS) {
      const int tn = tile / np4, tp = tile % np4;
      float acc[4][4];                    // [n][p]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 sv = *reinterpret_cast<const float4*>(st + (4 * tn + r) * P + 4 * tp);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = dq * comp(sv, c);
      }
      for (int j = 0; j < q; j += 4) {
        float4 bv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          bv[r] = *reinterpret_cast<const float4*>(bt + (4 * tn + r) * ldq + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          xv[jj] = *reinterpret_cast<const float4*>(xs + (j + jj) * P + 4 * tp);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(comp(bv[r], jj), comp(xv[jj], c), acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(st + (4 * tn + r) * P + 4 * tp) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int pp = i / N, n = i % N;
    p.final_state[sbase + i] = st[n * P + pp];
  }
}

constexpr int MAX_DEVICES = 64;
constexpr int MAX_SMEM_BYTES = smem_floats(MAX_Q, MAX_P, MAX_N) * (int)sizeof(float);

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // above 48 KB of shared memory, once per instance and device
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int bytes = smem_floats(round4(p.chunk), p.P, p.N) * (int)sizeof(float);
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; a and the states are
// fp32.  x (B, T, H, P), a (B, T, H), bm/cm (B, T, G, N), y (B, T, H, P);
// strides in elements, the last axis contiguous.  init may be null (zeros).
// Returns the cudaError_t of the launch (0 on success); nothing is
// synchronised.
extern "C" int ssd_scan(
    const void* x, const float* a, const void* bm, const void* cm,
    const float* init, void* y, float* final_state, int dtype,
    int B, int T, int H, int G, int P, int N, int chunk,
    long long x_sb, long long x_st, long long x_sh,
    long long a_sb, long long a_st, long long a_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long y_sb, long long y_st, long long y_sh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      chunk < 1 || chunk > MAX_Q || P < 4 || P > MAX_P || P % 4 != 0 ||
      N < 4 || N > MAX_N || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, a, bm, cm, init, y, final_state, B, T, H, G, P, N, chunk,
           x_sb, x_st, x_sh, a_sb, a_st, a_sh, b_sb, b_st, b_sg,
           c_sb, c_st, c_sg, y_sb, y_st, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, s);
    case 1: return (int)launch<__nv_bfloat16>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
