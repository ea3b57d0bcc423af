// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// No TPU kernel to replace: the TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssd_scan.py has no VJP, and the JAX model trains through
// autodiff of `ssd_chunked` (src/repro/models/ssm.py:52-121).  This is the
// counterpart of that autodiff for the forward of csrc/ssd_scan.cu, and
// computes the function of `ssd_chunked_bwd_ref` in
// src/repro_torch/kernels/ref.py.  Per (batch, head), with cs the chunk-local
// inclusive cumsum of the log decay a, L a chunk's last token, S the (P, N)
// fp32 state the chunk starts from and dS the gradient of the state it ends
// in:
//
// (a) a forward walk recomputes each chunk's entry state S (into a scratch
//     tensor the wrapper allocates for the call), where saving them in the
//     forward would keep (B, nc, H, P, N) fp32 per layer until the backward;
// (b) a reverse walk from dfinal, dS_{c-1} = e^{cs_L} dS_c
//     + sum_t e^{cs_t} dy_t C_t^T, ends in dinit = dS_{-1};
// (c) per chunk, from S and dS:
//       dx_j = sum_{i>=j} (C_i.B_j) e^{cs_i-cs_j} dy_i + e^{cs_L-cs_j} dS B_j
//       dB_j = sum_{i>=j} e^{cs_i-cs_j} (dy_i.x_j) C_i + e^{cs_L-cs_j} dS^T x_j
//       dC_i = sum_{j<=i} e^{cs_i-cs_j} (dy_i.x_j) B_j + e^{cs_i} S^T dy_i
//       d cs_i = sum_{j<i} M_ij - sum_{k>i} M_ki + e^{cs_i} C_i.(S^T dy_i) - u_i
//     with M_ij = (C_i.B_j) e^{cs_i-cs_j} (dy_i.x_j), u_i = e^{cs_L-cs_i}
//     x_i.(dS B_i), and d cs_L taking sum_i u_i + e^{cs_L} <dS, S>; da is
//     the in-chunk reverse cumsum of d cs.
//
// The decay is exponentiated only where j <= i (every exponent <= 0): at the
// real decay range (a down to about -1.6 a token, -100 over a chunk of 64)
// the entries above the diagonal would overflow to inf.
//
// Two kernels.  `ssd_bwd_walk_kernel`: one block of 512 threads per (head,
// batch) runs (a), then (b) and (c) chunk by chunk, everything in fp32 on the
// CUDA cores: x, dy, B, C, S, dS and the two Q x Q matrices C B^T and
// dy x^T in shared memory (205 KB at Q 64, P 64, N 128).  Each product lays
// the threads over its output with consecutive threads on consecutive
// columns, each thread owning up to 4 rows and 4 columns strided by the
// threads' width: the B operand's reads fall in distinct banks (x, B and dS,
// read down their columns, have odd row strides), the A operand's are
// broadcast.  It writes dx and da, and dB and dC of its head as fp32
// partials.  `ssd_bwd_group_sum_kernel` then sums the partials over the
// heads of each group in head order.  No atomics: every sum runs in a fixed
// order, so two launches give the same bits, and a CUDA graph replays the
// eager backward exactly.
//
// What bounds it on the H100: at mamba2-1.3b's training shape (B 8, T 512,
// 64 heads of P 64, N 128, one group, bf16) the call reads x, dy, a, B and C
// and writes dx, da, dB and dC, 107 MB (32 us at 3.35 TB/s), and does 38.7
// GFLOP, 39 us at the bf16 tensor-core peak (577 us at the fp32 peak of
// the CUDA cores it runs on).  This first version is far above that bound
// (PERF.md has its time): one block per (head, batch) walks its chunks in
// order, one block an SM for its shared memory, and its products read both
// operands from shared memory.  Tensor cores, TMA and several blocks a head
// are later work.
//
// Inputs: x (B, T, H, P), B and C (B, T, G, N), dy (B, T, H, P) in fp32 or
// bf16 (x, B, C one dtype, dy too), a (B, T, H) fp32, any strides in
// elements for the batch, token and head (group) axes with the last axis
// contiguous; init and dfinal (B, H, P, N) contiguous fp32 or null (zeros).
// Outputs, contiguous: dx (B, T, H, P) in x's dtype, da (B, T, H) fp32, dB
// and dC (B, T, G, N) in B's dtype, dinit (B, H, P, N) fp32 or null (not
// written).  Scratch, contiguous fp32: states (B, H, nc, P, N), dB and dC
// per head (B, T, H, N).  Launches on the given stream, allocates nothing
// and reads nothing back to the host, so a CUDA graph can capture it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;
constexpr int SUM_THREADS = 256;
constexpr int MAX_Q = 64, MAX_P = 64, MAX_N = 128;

struct Params {
  const void* x; const float* a; const void* bm; const void* cm;
  const void* dy; const float* init; const float* dfinal;
  void* dx; float* da; void* db; void* dc; float* dinit;
  float* states; float* dbh; float* dch;
  int B, T, H, G, P, N, chunk;
  long long x_sb, x_st, x_sh, a_sb, a_st, a_sh, b_sb, b_st, b_sg,
      c_sb, c_st, c_sg, dy_sb, dy_st, dy_sh;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// fp32 floats of shared memory for a chunk of Qp (a multiple of 4) tokens;
// x, B and dS rows are padded to an odd stride (conflict-free column reads)
__host__ __device__ constexpr int smem_floats(int qp, int p, int n) {
  return qp * (p + 1) + qp * p + qp * (n + 1) + qp * n + p * n + p * (n + 1)
         + 2 * qp * qp + qp * 32 + 8 * qp + THREADS + 32;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Runs f(TM, cs) with the threads laid over an output of nc columns: cs
// threads along the columns (4 cs >= nc, at most 32), each thread owning TM
// consecutive rows and the columns cx, cx + cs, cx + 2 cs, cx + 3 cs, so
// that the block covers 64 rows a pass.  Consecutive threads take
// consecutive columns: their reads of the B operand fall in distinct banks,
// and their reads of the A operand (the same rows) are broadcast.
__device__ __forceinline__ int tile_cols(int nc) {
  return nc > 64 ? 32 : nc > 32 ? 16 : nc > 16 ? 8 : 4;
}

// the rows a thread owns when cs threads lie along the columns: 64 rows a pass
__host__ __device__ constexpr int tile_rows(int cs) {
  return 64 * cs / THREADS > 0 ? 64 * cs / THREADS : 1;
}

template <class F>
__device__ __forceinline__ void with_tiles(int nc, F f) {
  switch (tile_cols(nc)) {
    case 32: f(std::integral_constant<int, tile_rows(32)>{}, 32); break;
    case 16: f(std::integral_constant<int, tile_rows(16)>{}, 16); break;
    case 8: f(std::integral_constant<int, tile_rows(8)>{}, 8); break;
    default: f(std::integral_constant<int, tile_rows(4)>{}, 4);
  }
}

// acc[i][j] += sum_{k0 <= k < k1} A(i, k) Bm(k, j), in order of k
template <int TM, class FA, class FB>
__device__ __forceinline__ void mac(float (&acc)[TM][4], int k0, int k1,
                                   FA A, FB Bm) {
  for (int k = k0; k < k1; ++k) {
    float av[TM], bv[4];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = A(i, k);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm(k, j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A thread's columns of a tile: cx + j cs for j < 4, clamped into range
// (ok(j): whether real); plain integers, so that they stay in registers
struct Cols {
  int cx, cs, last;
  __device__ __forceinline__ int operator()(int j) const {
    return min(cx + j * cs, last);
  }
  __device__ __forceinline__ bool ok(int j) const {
    return cx + j * cs <= last;
  }
};

// For every output tile of this thread over (m, nc) (m a multiple of 4):
// tile(TM, r0, col) with rows r0 .. r0 + TM - 1 and columns col
template <class F>
__device__ __forceinline__ void for_tiles(int m, int nc, F tile) {
  with_tiles(nc, [&](auto tm, int cs) {
    constexpr int TM = decltype(tm)::value;
    const Cols col{(int)threadIdx.x % cs, cs, nc - 1};
    for (int r0 = threadIdx.x / cs * TM; r0 < m; r0 += THREADS / cs * TM)
      tile(tm, r0, col);
  });
}

// rows [0, rows) of a (rows, cols) tile of a strided tensor into dst (row
// stride ld) as fp32, rows [rows, rows_pad) zero
template <typename T>
__device__ void load_rows(float* dst, int pitch, const T* src,
                          long long stride, int rows, int rows_pad, int cols) {
  for (int i = threadIdx.x; i < rows_pad * cols; i += THREADS) {
    const int r = i / cols, c = i - r * cols;
    dst[r * pitch + c] = r < rows ? ld(src + r * stride + c) : 0.f;
  }
}

// a deterministic block sum of one value a thread (two passes, fixed order);
// every thread gets the sum
__device__ float block_sum(float v, float* red, float* red32) {
  red[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = 0.f;
    for (int k = threadIdx.x; k < THREADS; k += 32) s += red[k];
    red32[threadIdx.x] = s;
  }
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < 32; ++k) s += red32[k];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_walk_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int g = h / (p.H / p.G);
  const int P = p.P, N = p.N, Q = p.chunk, Qp = round4(Q);
  const int nc = (p.T + Q - 1) / Q;
  const int LX = P + 1, LB = N + 1, LDS = N + 1;   // odd strides

  float* X = sm;                    // (Qp, P) x of the chunk, stride LX
  float* DY = X + Qp * LX;          // (Qp, P) dy
  float* Bs = DY + Qp * P;          // (Qp, N) B, stride LB
  float* Cs = Bs + Qp * LB;         // (Qp, N) C
  float* S = Cs + Qp * N;           // (P, N) the state the chunk starts from
  float* DS = S + P * N;            // (P, N) the gradient of the state after
                                    // the chunk, stride LDS
  float* G1 = DS + P * LDS;         // (Qp, Qp) C_i.B_j, then masked, decayed
  float* G2 = G1 + Qp * Qp;         // (Qp, Qp) dy_i.x_j, then masked, decayed
  float* PART = G2 + Qp * Qp;       // (Qp, 32) row partials of the threads
  float* CS = PART + Qp * 32;       // (Qp) cumsum of a
  float* ECS = CS + Qp;             // e^{cs_t}
  float* W = ECS + Qp;              // e^{cs_L - cs_t}
  float* DCS = W + Qp;              // d cs
  float* ROWS = DCS + Qp;           // sum_{j<i} M_ij
  float* COLS = ROWS + Qp;          // sum_{k>j} M_kj
  float* U = COLS + Qp;             // u_t
  float* VC = U + Qp;               // C_t.(S^T dy_t)
  float* RED = VC + Qp;             // (THREADS) block sums
  float* RED32 = RED + THREADS;     // (32)

  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const T* dyg = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const T* bg = static_cast<const T*>(p.bm) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.cm) + b * p.c_sb + g * p.c_sg;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const long long bh = (long long)b * p.H + h;
  float* states = p.states + bh * nc * P * N;

  // the chunk's cumsum of a, one thread, in token order
  auto cumsum = [&](int t0, int L) {
    for (int t = tid; t < Qp; t += THREADS)
      CS[t] = t < L ? ag[(t0 + t) * p.a_st] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int t = 0; t < Qp; ++t) { s += CS[t]; CS[t] = s; }
    }
    __syncthreads();
  };

  // ---- (a) the forward walk: each chunk's entry state into `states` ------
  for (int i = tid; i < P * N; i += THREADS)
    S[i] = p.init ? p.init[bh * P * N + i] : 0.f;
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    for (int i = tid; i < P * N; i += THREADS) states[c * P * N + i] = S[i];
    if (c == nc - 1) break;
    const int t0 = c * Q;
    const int L = min(Q, p.T - t0);
    load_rows(X, LX, xg + t0 * p.x_st, p.x_st, L, Qp, P);
    load_rows(Bs, LB, bg + t0 * p.b_st, p.b_st, L, Qp, N);
    cumsum(t0, L);
    const float eL = expf(CS[L - 1]);
    for (int t = tid; t < Qp; t += THREADS)
      W[t] = t < L ? expf(CS[L - 1] - CS[t]) : 0.f;
    __syncthreads();
    // S <- e^{cs_L} S + sum_t e^{cs_L - cs_t} x_t B_t^T, each thread its own
    // elements
    for_tiles(P, N, [&](auto tm, int r0, Cols col) {
      constexpr int TM = decltype(tm)::value;
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = eL * S[(r0 + i) * N + col(j)];
      mac<TM>(acc, 0, L,
              [&](int i, int k) { return W[k] * X[k * LX + r0 + i]; },
              [&](int k, int j) { return Bs[k * LB + col(j)]; });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col.ok(j)) S[(r0 + i) * N + col(j)] = acc[i][j];
    });
    __syncthreads();
  }

  // ---- (b), (c) the reverse walk ------------------------------------------
  for (int i = tid; i < P * N; i += THREADS)
    DS[i / N * LDS + i % N] = p.dfinal ? p.dfinal[bh * P * N + i] : 0.f;
  T* dxg = static_cast<T*>(p.dx);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * Q;
    const int L = min(Q, p.T - t0);
    __syncthreads();
    load_rows(X, LX, xg + t0 * p.x_st, p.x_st, L, Qp, P);
    load_rows(DY, P, dyg + t0 * p.dy_st, p.dy_st, L, Qp, P);
    load_rows(Bs, LB, bg + t0 * p.b_st, p.b_st, L, Qp, N);
    load_rows(Cs, N, cg + t0 * p.c_st, p.c_st, L, Qp, N);
    for (int i = tid; i < P * N; i += THREADS) S[i] = states[c * P * N + i];
    cumsum(t0, L);
    const float eL = expf(CS[L - 1]);
    for (int t = tid; t < Qp; t += THREADS) {
      ECS[t] = t < L ? expf(CS[t]) : 0.f;
      W[t] = t < L ? expf(CS[L - 1] - CS[t]) : 0.f;
    }

    // C B^T into G1 (rows [0, Qp) of the tiling), dy x^T into G2 (rows
    // [Qp, 2 Qp))
    for_tiles(2 * Qp, Qp, [&](auto tm, int r0, Cols col) {
      constexpr int TM = decltype(tm)::value;
      float acc[TM][4] = {};
      const bool second = r0 >= Qp;
      const int r = second ? r0 - Qp : r0;
      if (second)
        mac<TM>(acc, 0, P,
                [&](int i, int k) { return DY[(r + i) * P + k]; },
                [&](int k, int j) { return X[col(j) * LX + k]; });
      else
        mac<TM>(acc, 0, N,
                [&](int i, int k) { return Cs[(r + i) * N + k]; },
                [&](int k, int j) { return Bs[col(j) * LB + k]; });
      float* dst = second ? G2 : G1;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col.ok(j)) dst[(r + i) * Qp + col(j)] = acc[i][j];
    });
    __syncthreads();

    // the intra-chunk part of d cs: row sums and column sums of M off the
    // diagonal (the diagonal's terms cancel)
    if (tid < 2 * Qp) {
      const int t = tid % Qp;
      float s = 0.f;
      if (t < L) {
        if (tid < Qp) {
          for (int j = 0; j < t; ++j)
            s += G1[t * Qp + j] * G2[t * Qp + j] * expf(CS[t] - CS[j]);
        } else {
          for (int k = t + 1; k < L; ++k)
            s += G1[k * Qp + t] * G2[k * Qp + t] * expf(CS[k] - CS[t]);
        }
      }
      (tid < Qp ? ROWS : COLS)[t] = s;
    }
    __syncthreads();
    // G1 <- att = (C B^T) e^{cs_i - cs_j}, G2 <- (dy x^T) e^{cs_i - cs_j},
    // both where j <= i < L, else 0
    for (int e = tid; e < Qp * Qp; e += THREADS) {
      const int i = e / Qp, j = e - i * Qp;
      const float d = (j <= i && i < L) ? expf(CS[i] - CS[j]) : 0.f;
      G1[e] *= d;
      G2[e] *= d;
    }
    __syncthreads();

    // dx (Qp, P) = att^T dy + diag(w) dS B; x.(dS B) per row for u
    for_tiles(Qp, P, [&](auto tm, int r0, Cols col) {
      constexpr int TM = decltype(tm)::value;
      float acc[TM][4] = {}, rb[TM][4] = {};
      mac<TM>(acc, r0, Qp,
              [&](int i, int k) { return G1[k * Qp + r0 + i]; },
              [&](int k, int j) { return DY[k * P + col(j)]; });
      mac<TM>(rb, 0, N,
              [&](int i, int k) { return Bs[(r0 + i) * LB + k]; },
              [&](int k, int j) { return DS[col(j) * LDS + k]; });
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int j = r0 + i;
        float part = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (!col.ok(jj)) continue;
          part += X[j * LX + col(jj)] * rb[i][jj];
          if (j < L)
            st(dxg + ((long long)(b * p.T + t0 + j) * p.H + h) * P + col(jj),
               acc[i][jj] + W[j] * rb[i][jj]);
        }
        PART[j * 32 + col.cx] = part;
      }
    });
    __syncthreads();
    if (tid < Qp) {
      float s = 0.f;
      for (int q = 0; q < tile_cols(P); ++q) s += PART[tid * 32 + q];
      U[tid] = W[tid] * s;
      DCS[tid] = ROWS[tid] - COLS[tid] - U[tid];
    }
    __syncthreads();

    // dB and dC of this head (Qp, N), fp32 partials; C.(S^T dy) per row
    for_tiles(2 * Qp, N, [&](auto tm, int r0, Cols col) {
      constexpr int TM = decltype(tm)::value;
      float acc[TM][4] = {}, sv[TM][4] = {};
      if (r0 < Qp) {
        // dB_j = sum_{i>=j} G2_ij C_i + w_j dS^T x_j
        mac<TM>(acc, r0, Qp,
                [&](int i, int k) { return G2[k * Qp + r0 + i]; },
                [&](int k, int j) { return Cs[k * N + col(j)]; });
        mac<TM>(sv, 0, P,
                [&](int i, int k) { return X[(r0 + i) * LX + k]; },
                [&](int k, int j) { return DS[k * LDS + col(j)]; });
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int j = r0 + i;
          if (j < L)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (col.ok(jj))
                p.dbh[((long long)(b * p.T + t0 + j) * p.H + h) * N +
                      col(jj)] = acc[i][jj] + W[j] * sv[i][jj];
        }
      } else {
        // dC_i = sum_{j<=i} G2_ij B_j + e^{cs_i} S^T dy_i
        const int r = r0 - Qp;
        mac<TM>(acc, 0, r + TM,
                [&](int i, int k) { return G2[(r + i) * Qp + k]; },
                [&](int k, int j) { return Bs[k * LB + col(j)]; });
        mac<TM>(sv, 0, P,
                [&](int i, int k) { return DY[(r + i) * P + k]; },
                [&](int k, int j) { return S[k * N + col(j)]; });
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = r + i;
          float part = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (!col.ok(jj)) continue;
            part += Cs[t * N + col(jj)] * sv[i][jj];
            if (t < L)
              p.dch[((long long)(b * p.T + t0 + t) * p.H + h) * N +
                    col(jj)] = acc[i][jj] + ECS[t] * sv[i][jj];
          }
          PART[t * 32 + col.cx] = part;
        }
      }
    });
    float dot = 0.f;
    for (int i = tid; i < P * N; i += THREADS)
      dot += DS[i / N * LDS + i % N] * S[i];
    dot = block_sum(dot, RED, RED32);   // (its barriers also order PART)
    if (tid < Qp) {
      float s = 0.f;
      for (int q = 0; q < tile_cols(N); ++q) s += PART[tid * 32 + q];
      VC[tid] = ECS[tid] * s;
    }
    __syncthreads();

    // d cs, then da (one thread, in order), beside the dS update
    if (tid == 0) {
      float usum = 0.f;
      for (int t = 0; t < L; ++t) {
        DCS[t] += VC[t];
        usum += U[t];
      }
      DCS[L - 1] += usum + eL * dot;
      float s = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        s += DCS[t];
        p.da[(long long)(b * p.T + t0 + t) * p.H + h] = s;
      }
    }
    // dS <- e^{cs_L} dS + sum_t e^{cs_t} dy_t C_t^T, each thread its own
    // elements
    for_tiles(P, N, [&](auto tm, int r0, Cols col) {
      constexpr int TM = decltype(tm)::value;
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = eL * DS[(r0 + i) * LDS + col(j)];
      mac<TM>(acc, 0, L,
              [&](int i, int k) { return ECS[k] * DY[k * P + r0 + i]; },
              [&](int k, int j) { return Cs[k * N + col(j)]; });
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col.ok(j)) DS[(r0 + i) * LDS + col(j)] = acc[i][j];
    });
  }
  __syncthreads();
  if (p.dinit)
    for (int i = tid; i < P * N; i += THREADS)
      p.dinit[bh * P * N + i] = DS[i / N * LDS + i % N];
}

// dB (B, T, G, N) and dC in B's dtype: each head's fp32 partials summed over
// the heads of its group, in head order
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_group_sum_kernel(Params p) {
  const int r = p.H / p.G;
  const long long count = (long long)p.B * p.T * p.G * p.N;
  for (long long e = blockIdx.x * (long long)SUM_THREADS + threadIdx.x;
       e < 2 * count; e += (long long)gridDim.x * SUM_THREADS) {
    const bool is_c = e >= count;
    const long long i = is_c ? e - count : e;
    const int n = (int)(i % p.N);
    const long long bt = i / p.N / p.G;            // b * T + t
    const int g = (int)(i / p.N % p.G);
    const float* src = (is_c ? p.dch : p.dbh) + (bt * p.H + g * r) * p.N + n;
    float s = 0.f;
    for (int k = 0; k < r; ++k) s += src[(long long)k * p.N];
    st(static_cast<T*>(is_c ? p.dc : p.db) + i, s);
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  constexpr int max_bytes =
      smem_floats(MAX_Q, MAX_P, MAX_N) * (int)sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(ssd_bwd_walk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_bytes);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  const int bytes =
      smem_floats(round4(p.chunk), p.P, p.N) * (int)sizeof(float);
  ssd_bwd_walk_kernel<T><<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = 2LL * p.B * p.T * p.G * p.N;
  const long long blocks = (count + SUM_THREADS - 1) / SUM_THREADS;
  ssd_bwd_group_sum_kernel<T>
      <<<(int)(blocks < 4096 ? blocks : 4096), SUM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype of x, B, C, dy, dx, dB and dC: 0 = float32, 1 = bfloat16; a, the
// states and every sum are fp32.  Strides in elements (batch, token,
// head/group axes), the last axis contiguous; outputs and scratch are
// contiguous (see the header).  init and dfinal may be null (zeros), dinit
// null (not written).  Returns the cudaError_t of the launches (0 on
// success); nothing is synchronised.
extern "C" int ssd_scan_bwd(
    const void* x, const float* a, const void* bm, const void* cm,
    const void* dy, const float* init, const float* dfinal, void* dx,
    float* da, void* db, void* dc, float* dinit, float* states, float* dbh,
    float* dch, int dtype, int B, int T, int H, int G, int P, int N,
    int chunk, long long x_sb, long long x_st, long long x_sh,
    long long a_sb, long long a_st, long long a_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long dy_sb, long long dy_st, long long dy_sh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      H > 65535 || chunk < 1 || chunk > MAX_Q || P < 4 || P > MAX_P ||
      P % 4 != 0 || N < 4 || N > MAX_N || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, a, bm, cm, dy, init, dfinal, dx, da, db, dc, dinit, states,
           dbh, dch, B, T, H, G, P, N, chunk,
           x_sb, x_st, x_sh, a_sb, a_st, a_sh, b_sb, b_st, b_sg,
           c_sb, c_st, c_sg, dy_sb, dy_st, dy_sh};
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
