// Flash-attention backward for Hopper (sm_90a), CUDA C++.
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
// Two kernels, as on the TPU: `dq` owns a query tile of one head and walks
// the K/V tiles in its causal/window horizon (the TPU kernel's [lo, hi));
// `dkv` owns a key tile of one kv head and walks the query tiles of every
// query head of its GQA group inside [lo, hi).  Each output element is
// written by exactly one block, so no atomics are needed and the result is
// deterministic.  Sums run in fp32 registers and are rounded once at the
// write.  The entry points pick the kernel by dtype:
//
// * bf16 (every training path): `flash_bwd_dq_bf16_kernel` and
//   `flash_bwd_dkv_bf16_kernel`, every product on the tensor cores
//   (mma.sync m16n8k16, fp32 accumulators, helpers of mma_sm90.cuh).
// * fp32 (the card-vs-CPU checks only): `flash_bwd_*_f32_kernel`, the
//   products on the CUDA cores in fp32.  An fp32 tensor-core product would
//   be TF32, which keeps about three decimal digits.
//
// What bounds them on the H100: at the training shape (B 4, S 512, 16 heads
// of 128, bf16, causal) dq does 3 and dkv 4 products of the forward's size,
// 6.5 and 8.6 GFLOP, ~6.5 and ~8.7 us at the bf16 tensor-core peak, against
// 42 MB (dq) and 51 MB (dkv) of inputs and outputs, 12.6 and 15.1 us at
// 3.35 TB/s: memory bounds both.  What the bf16 design does about it: each
// block reads its resident tiles once and each streamed tile of its horizon
// once, in 16-byte `cp.async` copies through a two-stage ring, so the next
// tile is in flight while this one is multiplied; tiles stay bf16 in
// shared memory with the XOR swizzle of mma_sm90.cuh; the S x S scores,
// probabilities and their gradients never leave registers.
//
// bf16 dq: one block of 4 warps per (q head, batch, 64-row query tile),
// each warp owning 16 query rows; the query tile is the slowest grid axis,
// walked from the last tile down, so the longest causal rows start first.
// Q and dO are loaded once; K/V tiles of 64 keys (32 at D 256, where the
// 16 x 256 fp32 dQ accumulator already takes 128 registers a thread) stream
// through the ring.  S = Q K^T and dP = dO V^T come out as C fragments;
// P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - delta) are taken
// in place, masked entries set to 0 only on tiles that cross an edge (the
// diagonal, the window's low edge, the ragged end); dS packed to bf16x2 is
// the A fragment of dQ += dS K, with K the B operand through
// ldmatrix.trans.  dQ is scaled, rounded once and staged through the
// warp's own rows of the Q tile for 16-byte stores.
//
// bf16 dkv: one block of 4 warps per (kv head, batch, key tile); the key
// tile is the slowest grid axis, walked upwards, so under causal masking
// the tiles with the longest query walks start first.  K and V stay
// resident; Q, dO, lse and delta of each query tile of each query head of
// the group stream through the ring.  S^T = K Q^T and dP^T = V dO^T have
// the keys as rows, so P^T and dS^T land in C fragments whose rows are
// keys and feed dV += P^T dO and dK += dS^T Q directly as A fragments (no
// shared-memory round trip), with dO and Q the B operands through
// ldmatrix.trans.  The register budget: two fp32 accumulators of
// (16 keys x D) are D registers a thread, so at D >= 120 the streamed
// query tile is 32 rows (S^T and dP^T take 32 registers, not 64), and at
// D 256 two warps share 16 keys, each accumulating half of D's columns
// (both compute the same S^T and dP^T, so the key tile is 32).
//
// Head dims: the products over D (Q K^T, dO V^T, K Q^T, V dO^T) run over D
// rounded up to 16: at D 120 columns 120-127 of every tile are zero-filled
// by the copy, so those k16 steps add exact zeros; the products into D
// (dS K, P^T dO, dS^T Q) cover D / 8 n8 tiles (15 at D 120, the last one
// through ldmatrix.x2.trans) and only columns below D are written.  A
// swizzled row holds whole groups of 8 chunks, so rows of D 32 and 80 are
// stored 64 and 128 columns wide.  P and dS are rounded to bf16 before the
// second products (as SDPA's backward does); the sums stay fp32.
//
// fp32 layout: one block of 256 threads (8 warps) per tile of T rows
// (T = 64, or 32 at D 256, where 64-row fp32 tiles would need 281 KB of
// shared memory); D is padded with zero columns to a multiple of 32 in
// shared memory (96 at D 80, 128 at D 120).  In `dq` each warp owns T / 8
// query rows and a lane the logits of its rows against keys `lane` (and
// `lane + 32`), then output columns `lane + 32 c` of dQ; in `dkv` each warp
// owns T / 8 keys, a lane their logits against queries `lane` (and
// `lane + 32`), then columns `lane + 32 c` of dK and dV.  Only columns below
// D are written.
//
// Queries and keys may differ in number (Sq and Sk: cross-attention, full
// and non-causal): `dq`'s grid covers the Sq query rows and walks the Sk
// keys, `dkv`'s covers the Sk keys and walks the Sq query rows.  Rows past
// Sq and keys past Sk (ragged tails) load as zeros and are masked.
// Strides are in elements for the batch, head and sequence axes (the last
// axis is contiguous); every row starts on a 16-byte boundary, which the
// Python wrapper checks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;                    // (B, Hq, Sq) contiguous
  const float* delta;                  // (B, Hq, Sq) contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, Hq, Hkv, Sq, Sk;              // query and key lengths
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;          // dO
  long long a_sb, a_sh, a_ss;          // dq, or dk
  long long c_sb, c_sh, c_ss;          // dv (dkv only)
  int causal, window;
  float scale;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return qpos < p.Sq && kpos < p.Sk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int STAGES = 2;              // depth of the streamed-tile ring

template <int D>
struct Dims {
  static_assert(D % 8 == 0 && D <= 256, "head dim: a multiple of 8, at most 256");
  static constexpr int DK = (D + 15) / 16 * 16;          // depth of products over D
  static constexpr int KSTEPS = DK / 16;
  static constexpr int NT = D / 8;                       // n8 tiles of a D-wide output
  static constexpr int COPY = DK / 8;                    // chunks copied a row
  static constexpr int CHUNKS = (COPY + 7) / 8 * 8;      // chunks stored a row
};

template <int D>
struct DqTile : Dims<D> {
  static constexpr int BQ = 16 * TC_WARPS;               // query rows a block
  static constexpr int BK = D > 128 ? 32 : 64;           // keys a K/V tile
  static constexpr int SN = BK / 8;                      // n8 tiles of scores
  static constexpr int SMEM = (2 * BQ + 2 * STAGES * BK) * Dims<D>::CHUNKS * 16;
};

template <int D>
struct DkvTile : Dims<D> {
  static constexpr int SPLIT = D > 128 ? 2 : 1;          // warps sharing 16 keys
  static constexpr int KGROUPS = TC_WARPS / SPLIT;       // 16-key groups a block
  static constexpr int BK = 16 * KGROUPS;                // keys a block
  static constexpr int NTW = Dims<D>::NT / SPLIT;        // n8 tiles of dK/dV a warp
  static constexpr int BQ = D >= 120 ? 32 : 64;          // queries a streamed tile
  static constexpr int SN = BQ / 8;
  static constexpr int SMEM = (2 * BK + 2 * STAGES * BQ) * Dims<D>::CHUNKS * 16 +
                              2 * STAGES * BQ * (int)sizeof(float);
  static_assert(Dims<D>::NT % SPLIT == 0, "each warp of a pair takes whole n8 tiles");
};

// rows [row0, row0 + rows) of one head, `chunks` 16-byte chunks a row, into
// a swizzled tile; chunks at or past `valid_chunks` and rows at or past S
// (the tile's sequence length, Sq or Sk) are written as zeros
template <int CHUNKS>
__device__ __forceinline__ void copy_tile(uint4* tile, const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int rows, int chunks,
                                          int valid_chunks, int S) {
  for (int i = threadIdx.x; i < rows * chunks; i += TC_THREADS) {
    const int r = i / chunks;
    const int c = i % chunks;
    const bool ok = row0 + r < S && c < valid_chunks;
    const __nv_bfloat16* src =
        ok ? base + (long long)(row0 + r) * row_stride + c * 8 : base;
    sm90::cp_async_16(sm90::smem_addr(tile + sm90::swizzle<CHUNKS>(r, c)), src,
                      ok);
  }
}

// the four bf16x2 registers of an A fragment from two n8 C fragments
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = sm90::pack_bf16x2(c0[0], c0[1]);
  a[1] = sm90::pack_bf16x2(c0[2], c0[3]);
  a[2] = sm90::pack_bf16x2(c1[0], c1[1]);
  a[3] = sm90::pack_bf16x2(c1[2], c1[3]);
}

// acc[n] += a * B for the n8 tiles [c0, c0 + N) of a tile whose rows are
// the k16 step's 16 rows starting at `row16`: B (k = tile row, n = column)
// through ldmatrix.trans
template <int N, int CH>
__device__ __forceinline__ void mma_rows_trans(float (&acc)[N][4],
                                               const uint32_t (&a)[4],
                                               const uint4* tile, int row16,
                                               int c0, int lane) {
  const int row = row16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int n = 0; n + 1 < N; n += 2) {
    uint32_t b[4];
    sm90::ldmatrix_x4_trans(b, sm90::smem_addr(
        tile + sm90::swizzle<CH>(row, c0 + n + (lane >> 4))));
    sm90::mma_bf16_16816(acc[n], a, b[0], b[1]);
    sm90::mma_bf16_16816(acc[n + 1], a, b[2], b[3]);
  }
  if constexpr (N % 2 == 1) {
    uint32_t b[2];
    sm90::ldmatrix_x2_trans(b, sm90::smem_addr(
        tile + sm90::swizzle<CH>(row, c0 + N - 1)));
    sm90::mma_bf16_16816(acc[N - 1], a, b[0], b[1]);
  }
}

// x += A1 B1^T and y += A2 B2^T over the depth of DK columns, for the 16
// rows of A1/A2 starting at `arow` and the SN * 8 rows of B1/B2 from 0:
// both A operands through ldmatrix, both B operands (rows are the n axis)
// through ldmatrix without transposition
template <int KSTEPS, int SN, int CH>
__device__ __forceinline__ void mma_pair_nt(float (&x)[SN][4], float (&y)[SN][4],
                                            const uint4* a1, const uint4* a2,
                                            int arow, const uint4* b1,
                                            const uint4* b2, int lane) {
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = y[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t fa1[4], fa2[4];
    const int ac = sm90::swizzle<CH>(arow + (lane & 15), 2 * kk + (lane >> 4));
    sm90::ldmatrix_x4(fa1, sm90::smem_addr(a1 + ac));
    sm90::ldmatrix_x4(fa2, sm90::smem_addr(a2 + ac));
#pragma unroll
    for (int n = 0; n < SN; n += 2) {
      const int bc = sm90::swizzle<CH>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kk + ((lane >> 3) & 1));
      uint32_t fb[4];
      sm90::ldmatrix_x4(fb, sm90::smem_addr(b1 + bc));
      sm90::mma_bf16_16816(x[n], fa1, fb[0], fb[1]);
      sm90::mma_bf16_16816(x[n + 1], fa1, fb[2], fb[3]);
      sm90::ldmatrix_x4(fb, sm90::smem_addr(b2 + bc));
      sm90::mma_bf16_16816(y[n], fa2, fb[0], fb[1]);
      sm90::mma_bf16_16816(y[n + 1], fa2, fb[2], fb[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dq_bf16_kernel(const Params p) {
  using Tl = DqTile<D>;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, CH = Tl::CHUNKS, NT = Tl::NT,
                SN = Tl::SN;

  extern __shared__ uint4 smem[];
  uint4* Qs = smem;                              // BQ rows
  uint4* dOs = Qs + BQ * CH;                     // BQ rows
  uint4* Ks = dOs + BQ * CH;                     // STAGES x BK rows
  uint4* Vs = Ks + STAGES * BK * CH;             // STAGES x BK rows

  const int qt = (int)(gridDim.z - 1 - blockIdx.z);   // longest causal rows first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr = warp * 16;                   // this warp's rows of the tile
  const int row_a = q0 + wr + g;              // the two query rows of a lane
  const int row_b = row_a + 8;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the TPU kernel's tile range [lo, hi) (flash_attention.py:133-140)
  const int nkb = (p.Sk + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + BQ + BK - 1) / BK, nkb) : nkb;
  const int lo = p.window > 0 ? max(floor_div(q0 - p.window + 1, BK), 0) : 0;

  auto load_kv = [&](int kt, int stage) {
    copy_tile<CH>(Ks + stage * BK * CH, kg, p.k_ss, kt * BK, BK, Tl::COPY, NT,
                  p.Sk);
    copy_tile<CH>(Vs + stage * BK * CH, vg, p.v_ss, kt * BK, BK, Tl::COPY, NT,
                  p.Sk);
  };

  // group 0: Q, dO and the first K/V tile
  copy_tile<CH>(Qs, qg, p.q_ss, q0, BQ, Tl::COPY, NT, p.Sq);
  copy_tile<CH>(dOs, og, p.o_ss, q0, BQ, Tl::COPY, NT, p.Sq);
  load_kv(lo, 0);
  sm90::cp_async_commit();

  // lse (in log2 units) and delta of the lane's two rows
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
  float lse2[2], dl[2];
  lse2[0] = row_a < p.Sq ? p.lse[row_base + row_a] * LOG2E : 0.f;
  lse2[1] = row_b < p.Sq ? p.lse[row_base + row_b] * LOG2E : 0.f;
  dl[0] = row_a < p.Sq ? p.delta[row_base + row_a] : 0.f;
  dl[1] = row_b < p.Sq ? p.delta[row_base + row_b] : 0.f;
  const float sl2 = p.scale * LOG2E;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = lo, it = 0; kt < hi; ++kt, ++it) {
    const int stage = it % STAGES;
    if (kt + 1 < hi) load_kv(kt + 1, (it + 1) % STAGES);
    sm90::cp_async_commit();          // maybe empty: one group an iteration
    sm90::cp_async_wait<1>();         // tile kt (and Q, dO) have landed
    __syncthreads();
    const uint4* ks = Ks + stage * BK * CH;
    const uint4* vs = Vs + stage * BK * CH;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and BK keys
    float s[SN][4], dp[SN][4];
    mma_pair_nt<Tl::KSTEPS, SN, CH>(s, dp, Qs, dOs, wr, ks, vs, lane);

    // P and dS in place; the mask only on tiles that cross an edge for
    // this warp's rows
    const int k0 = kt * BK;
    const int w0 = q0 + wr;
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > w0) ||
                      (p.window > 0 && k0 <= w0 + 15 - p.window);
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(fmaf(s[n][e], sl2, -lse2[e >> 1]));
        if (edge && !visible(p, e < 2 ? row_a : row_b,
                             k0 + n * 8 + 2 * t + (e & 1)))
          pe = 0.f;                    // masked: probability 0
        dp[n][e] = pe * (dp[n][e] - dl[e >> 1]);
      }

    // dQ += dS K: two n8 tiles of dS, packed to bf16, are one k16 A fragment
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      uint32_t a[4];
      pack_a(a, dp[2 * kk], dp[2 * kk + 1]);
      mma_rows_trans<NT, CH>(acc, a, ks, 16 * kk, 0, lane);
    }
    __syncthreads();                  // this stage is refilled next iteration
  }
  sm90::cp_async_wait<0>();

  // dQ = scale * acc, staged through this warp's own rows of the Q tile (no
  // other warp reads them), then stored 16 bytes a lane
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t* ra = reinterpret_cast<uint32_t*>(Qs + sm90::swizzle<CH>(wr + g, n));
    uint32_t* rb = reinterpret_cast<uint32_t*>(Qs + sm90::swizzle<CH>(wr + g + 8, n));
    ra[t] = sm90::pack_bf16x2(acc[n][0] * p.scale, acc[n][1] * p.scale);
    rb[t] = sm90::pack_bf16x2(acc[n][2] * p.scale, acc[n][3] * p.scale);
  }
  __syncwarp();
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.a_sb + h * p.a_sh;
  for (int i = lane; i < 16 * NT; i += 32) {
    const int r = i / NT;
    const int c = i % NT;
    const int row = q0 + wr + r;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(dqg + (long long)row * p.a_ss + c * 8) =
          Qs[sm90::swizzle<CH>(wr + r, c)];
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_bwd_dkv_bf16_kernel(const Params p) {
  using Tl = DkvTile<D>;
  constexpr int BK = Tl::BK, BQ = Tl::BQ, CH = Tl::CHUNKS, NT = Tl::NT,
                NTW = Tl::NTW, SN = Tl::SN;

  extern __shared__ uint4 smem[];
  uint4* Ks = smem;                              // BK rows
  uint4* Vs = Ks + BK * CH;                      // BK rows
  uint4* Qs = Vs + BK * CH;                      // STAGES x BQ rows
  uint4* dOs = Qs + STAGES * BQ * CH;            // STAGES x BQ rows
  float* Ls = reinterpret_cast<float*>(dOs + STAGES * BQ * CH);  // STAGES x BQ
  float* Dl = Ls + STAGES * BQ;                  // STAGES x BQ

  const int kt = blockIdx.z;          // causal: the longest query walks first
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kr = (warp % Tl::KGROUPS) * 16;     // this warp's 16 keys of the tile
  const int c0 = (warp / Tl::KGROUPS) * NTW;    // its first n8 tile of dK / dV
  const int key_a = k0 + kr + g;                // the two keys of a lane
  const int key_b = key_a + 8;

  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the TPU kernel's query-tile range [lo, hi) (flash_attention.py:176-186),
  // walked for each query head of the group in turn
  const int nqb = (p.Sq + BQ - 1) / BQ;
  const int lo = p.causal ? k0 / BQ : 0;
  const int hi = p.window > 0 ? min((k0 + BK + p.window - 2) / BQ + 1, nqb)
                              : nqb;
  const int per_head = max(hi - lo, 0);
  const int total = group * per_head;

  auto load_q = [&](int j, int stage) {
    const int h = hk * group + j / per_head;
    const int q0 = (lo + j % per_head) * BQ;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(p.dout) + b * p.o_sb + h * p.o_sh;
    copy_tile<CH>(Qs + stage * BQ * CH, qg, p.q_ss, q0, BQ, Tl::COPY, NT, p.Sq);
    copy_tile<CH>(dOs + stage * BQ * CH, og, p.o_ss, q0, BQ, Tl::COPY, NT,
                  p.Sq);
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int i = threadIdx.x; i < 2 * BQ; i += TC_THREADS) {
      const int r = i % BQ;
      const bool ok = q0 + r < p.Sq;
      const float* src = (i < BQ ? p.lse : p.delta) + (ok ? row_base + q0 + r : 0);
      sm90::cp_async_4(sm90::smem_addr((i < BQ ? Ls : Dl) + stage * BQ + r),
                       src, ok);
    }
  };

  // group 0: K, V and the first query tile
  copy_tile<CH>(Ks, kg, p.k_ss, k0, BK, Tl::COPY, NT, p.Sk);
  copy_tile<CH>(Vs, vg, p.v_ss, k0, BK, Tl::COPY, NT, p.Sk);
  if (total > 0) load_q(0, 0);
  sm90::cp_async_commit();

  float dk[NTW][4], dv[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl2 = p.scale * LOG2E;

  for (int j = 0; j < total; ++j) {
    const int stage = j % STAGES;
    if (j + 1 < total) load_q(j + 1, (j + 1) % STAGES);
    sm90::cp_async_commit();          // maybe empty: one group an iteration
    sm90::cp_async_wait<1>();         // tile j (and K, V) have landed
    __syncthreads();
    const uint4* qs = Qs + stage * BQ * CH;
    const uint4* dos = dOs + stage * BQ * CH;
    const float* ls = Ls + stage * BQ;
    const float* dls = Dl + stage * BQ;
    const int q0 = (lo + j % per_head) * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and BQ queries
    float s[SN][4], dp[SN][4];
    mma_pair_nt<Tl::KSTEPS, SN, CH>(s, dp, Ks, Vs, kr, qs, dos, lane);

    // P^T and dS^T in place: rows are keys, columns queries
    const int kw0 = k0 + kr;
    const bool edge = q0 + BQ > p.Sq || kw0 + 16 > p.Sk ||
                      (p.causal && kw0 + 15 > q0) ||
                      (p.window > 0 && kw0 <= q0 + BQ - 1 - p.window);
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(ls + n * 8 + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(dls + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l.y : l.x;
        const float dlt = (e & 1) ? d.y : d.x;
        float pe = exp2f(fmaf(s[n][e], sl2, -lq * LOG2E));
        if (edge && !visible(p, q0 + n * 8 + 2 * t + (e & 1),
                             e < 2 ? key_a : key_b))
          pe = 0.f;                    // masked: probability 0
        s[n][e] = pe;
        dp[n][e] = pe * (dp[n][e] - dlt);
      }
    }

    // dV += P^T dO and dK += dS^T Q: two n8 tiles, packed to bf16, are one
    // k16 A fragment; dO and Q are the B operands through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      uint32_t pa[4], da[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
      mma_rows_trans<NTW, CH>(dv, pa, dos, 16 * kk, c0, lane);
      mma_rows_trans<NTW, CH>(dk, da, qs, 16 * kk, c0, lane);
    }
    __syncthreads();                  // this stage is refilled next iteration
  }
  sm90::cp_async_wait<0>();
  __syncthreads();                    // every warp is done with K and V

  // dK = scale * acc and dV, staged through the K and V tiles, then stored
  // 16 bytes a thread
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    const int ca = sm90::swizzle<CH>(kr + g, c0 + n);
    const int cb = sm90::swizzle<CH>(kr + g + 8, c0 + n);
    reinterpret_cast<uint32_t*>(Ks + ca)[t] =
        sm90::pack_bf16x2(dk[n][0] * p.scale, dk[n][1] * p.scale);
    reinterpret_cast<uint32_t*>(Ks + cb)[t] =
        sm90::pack_bf16x2(dk[n][2] * p.scale, dk[n][3] * p.scale);
    reinterpret_cast<uint32_t*>(Vs + ca)[t] = sm90::pack_bf16x2(dv[n][0], dv[n][1]);
    reinterpret_cast<uint32_t*>(Vs + cb)[t] = sm90::pack_bf16x2(dv[n][2], dv[n][3]);
  }
  __syncthreads();
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.a_sb + hk * p.a_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.c_sb + hk * p.c_sh;
  for (int i = threadIdx.x; i < BK * NT; i += TC_THREADS) {
    const int r = i / NT;
    const int c = i % NT;
    const int row = k0 + r;
    if (row < p.Sk) {
      *reinterpret_cast<uint4*>(dkg + (long long)row * p.a_ss + c * 8) =
          Ks[sm90::swizzle<CH>(r, c)];
      *reinterpret_cast<uint4*>(dvg + (long long)row * p.c_ss + c * 8) =
          Vs[sm90::swizzle<CH>(r, c)];
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <int D>
struct F32 {
  static constexpr int DP = (D + 31) / 32 * 32;   // D padded with zero columns
  static constexpr int T = D > 128 ? 32 : 64;     // rows and keys a tile
  static constexpr int ROWS = T / WARPS;          // rows (queries or keys) a warp
  static constexpr int KPL = T / 32;              // logits a lane for each row
  static constexpr int DPL = DP / 32;             // output columns a lane
  static constexpr int LD = DP + 4;               // padded: conflict-free 16-byte reads
  // dq: Q (scaled) and dO [T][DP]; K and V [T][LD]; dS [T][T]
  static constexpr int DQ_SMEM = (2 * T * DP + 2 * T * LD + T * T) * (int)sizeof(float);
  // dkv: K and V [T][DP]; Q (scaled) and dO [T][LD]; P^T and dS^T [T][T];
  // lse and delta of the query tile [T] each
  static constexpr int DKV_SMEM =
      (2 * T * DP + 2 * T * LD + 2 * T * T + 2 * T) * (int)sizeof(float);
};

// Stage rows [row0, row0 + rows) of one head into shared memory with leading
// dimension LD, times `scale`; columns D..DP-1 and rows at or past S become
// zeros.
template <int D, int DP, int LD>
__device__ void load_tile(float* smem, const float* base, long long row_stride,
                          int row0, int rows, int S, float scale) {
  constexpr int CPR = DP / 4;          // 16-byte chunks a stored row
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S && c < D) {
      a = *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * row_stride + c);
      a.x *= scale; a.y *= scale; a.z *= scale; a.w *= scale;
    }
    *reinterpret_cast<float4*>(smem + r * LD + c) = a;
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

// dQ: one block per (q head, batch, query tile)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const Params p) {
  using F = F32<D>;
  constexpr int T = F::T, DP = F::DP, LD = F::LD, ROWS = F::ROWS,
                KPL = F::KPL, DPL = F::DPL;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + T * DP;
  float* Ks = dOs + T * DP;
  float* Vs = Ks + T * LD;
  float* dSs = Vs + T * LD;

  const int qt = (int)(gridDim.z - 1 - blockIdx.z);   // longest causal rows first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * T;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* og = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row_base = ((long long)b * p.Hq + h) * p.Sq;

  load_tile<D, DP, DP>(Qs, qg, p.q_ss, q0, T, p.Sq, p.scale);
  load_tile<D, DP, DP>(dOs, og, p.o_ss, q0, T, p.Sq, 1.f);

  float lse[ROWS], delta[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    lse[r] = row < p.Sq ? p.lse[row_base + row] : 0.f;
    delta[r] = row < p.Sq ? p.delta[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // the TPU kernel's tile range [lo, hi) (flash_attention.py:133-140)
  const int nkb = (p.Sk + T - 1) / T;
  const int hi = p.causal ? min((q0 + 2 * T - 1) / T, nkb) : nkb;
  const int lo = p.window > 0 ? max(floor_div(q0 - p.window + 1, T), 0) : 0;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * T;
    __syncthreads();                   // every warp is done with the last K, V
    load_tile<D, DP, LD>(Ks, kg, p.k_ss, k0, T, p.Sk, 1.f);
    load_tile<D, DP, LD>(Vs, vg, p.v_ss, k0, T, p.Sk, 1.f);
    __syncthreads();

    // s = (scale Q) K^T and dp = dO V^T for this warp's rows against keys
    // lane + 32 c
    float s[ROWS][KPL], dp[ROWS][KPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < KPL; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 ka[KPL], va[KPL];
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        ka[c] = *reinterpret_cast<const float4*>(Ks + (lane + 32 * c) * LD + d);
        va[c] = *reinterpret_cast<const float4*>(Vs + (lane + 32 * c) * LD + d);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (r0 + r) * DP + d);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + (r0 + r) * DP + d);
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          s[r][c] = dot4(qv, ka[c], s[r][c]);
          dp[r][c] = dot4(ov, va[c], dp[r][c]);
        }
      }
    }

    // dS = P (dp - delta), P recomputed from lse; this warp's rows only
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int kpos = k0 + lane + 32 * c;
        const float pr = visible(p, qpos, kpos) ? expf(s[r][c] - lse[r]) : 0.f;
        dSs[(r0 + r) * T + lane + 32 * c] = pr * (dp[r][c] - delta[r]);
      }
    }
    __syncwarp();

    // acc += dS K
#pragma unroll 2
    for (int j = 0; j < T; j += 4) {
      float4 ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        ds[r] = *reinterpret_cast<const float4*>(dSs + (r0 + r) * T + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kk[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) kk[c] = Ks[(j + jj) * LD + lane + 32 * c];
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

  float* dqg = static_cast<float*>(p.dq) + b * p.a_sb + h * p.a_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < D)
        dqg[row * p.a_ss + lane + 32 * c] = acc[r][c] * p.scale;
  }
}

// dK, dV: one block per (kv head, batch, key tile), summed over the GQA group
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const Params p) {
  using F = F32<D>;
  constexpr int T = F::T, DP = F::DP, LD = F::LD, ROWS = F::ROWS,
                KPL = F::KPL, DPL = F::DPL;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + T * DP;
  float* Qs = Vs + T * DP;
  float* dOs = Qs + T * LD;
  float* Pt = dOs + T * LD;
  float* dSt = Pt + T * T;
  float* Ls = dSt + T * T;
  float* Dl = Ls + T;

  const int kt = blockIdx.z;           // causal: the longest query walks first
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int group = p.Hq / p.Hkv;
  const int k0 = kt * T;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<D, DP, DP>(Ks, kg, p.k_ss, k0, T, p.Sk, 1.f);
  load_tile<D, DP, DP>(Vs, vg, p.v_ss, k0, T, p.Sk, 1.f);

  float dk[ROWS][DPL], dv[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk[r][c] = dv[r][c] = 0.f;
  }

  // the TPU kernel's query-tile range [lo, hi) (flash_attention.py:176-186)
  const int nqb = (p.Sq + T - 1) / T;
  const int lo = p.causal ? k0 / T : 0;
  const int hi = p.window > 0 ? min((k0 + T + p.window - 2) / T + 1, nqb)
                              : nqb;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* og = static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long row_base = ((long long)b * p.Hq + h) * p.Sq;
    for (int it = lo; it < hi; ++it) {
      const int q0 = it * T;
      __syncthreads();                 // every warp is done with the last tile
      load_tile<D, DP, LD>(Qs, qg, p.q_ss, q0, T, p.Sq, p.scale);
      load_tile<D, DP, LD>(dOs, og, p.o_ss, q0, T, p.Sq, 1.f);
      if (threadIdx.x < T) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < p.Sq ? p.lse[row_base + row] : 0.f;
        Dl[threadIdx.x] = row < p.Sq ? p.delta[row_base + row] : 0.f;
      }
      __syncthreads();

      // s^T = K (scale Q)^T and dp^T = V dO^T for this warp's keys against
      // queries lane + 32 c
      float s[ROWS][KPL], dp[ROWS][KPL];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < KPL; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 4) {
        float4 qa[KPL], oa[KPL];
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          qa[c] = *reinterpret_cast<const float4*>(Qs + (lane + 32 * c) * LD + d);
          oa[c] = *reinterpret_cast<const float4*>(dOs + (lane + 32 * c) * LD + d);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (r0 + r) * DP + d);
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (r0 + r) * DP + d);
#pragma unroll
          for (int c = 0; c < KPL; ++c) {
            s[r][c] = dot4(kv, qa[c], s[r][c]);
            dp[r][c] = dot4(vv, oa[c], dp[r][c]);
          }
        }
      }

#pragma unroll
      for (int c = 0; c < KPL; ++c) {
        const int qi = lane + 32 * c;
        const float l = Ls[qi];
        const float dl = Dl[qi];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int kpos = k0 + r0 + r;
          const float pr = visible(p, q0 + qi, kpos) ? expf(s[r][c] - l) : 0.f;
          Pt[(r0 + r) * T + qi] = pr;
          dSt[(r0 + r) * T + qi] = pr * (dp[r][c] - dl);
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T (scale Q)
#pragma unroll 1
      for (int j = 0; j < T; j += 4) {
        float4 pr[ROWS], ds[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          pr[r] = *reinterpret_cast<const float4*>(Pt + (r0 + r) * T + j);
          ds[r] = *reinterpret_cast<const float4*>(dSt + (r0 + r) * T + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float oo[DPL], qq[DPL];
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            oo[c] = dOs[(j + jj) * LD + lane + 32 * c];
            qq[c] = Qs[(j + jj) * LD + lane + 32 * c];
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

  float* dkg = static_cast<float*>(p.dk) + b * p.a_sb + hk * p.a_sh;
  float* dvg = static_cast<float*>(p.dv) + b * p.c_sb + hk * p.c_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = k0 + r0 + r;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      if (lane + 32 * c < D) {
        dkg[row * p.a_ss + lane + 32 * c] = dk[r][c];
        dvg[row * p.c_ss + lane + 32 * c] = dv[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = tc ? DqTile<D>::SMEM : F32<D>::DQ_SMEM;
  constexpr int threads = tc ? TC_THREADS : THREADS;
  constexpr int rows = tc ? DqTile<D>::BQ : F32<D>::T;
  void (*kernel)(const Params) =
      tc ? &flash_bwd_dq_bf16_kernel<D> : &flash_bwd_dq_f32_kernel<D>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  // the query tile is the slowest grid axis (see the kernels)
  const dim3 grid(p.Hq, p.B, (p.Sq + rows - 1) / rows);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = tc ? DkvTile<D>::SMEM : F32<D>::DKV_SMEM;
  constexpr int threads = tc ? TC_THREADS : THREADS;
  constexpr int keys = tc ? DkvTile<D>::BK : F32<D>::T;
  void (*kernel)(const Params) =
      tc ? &flash_bwd_dkv_bf16_kernel<D> : &flash_bwd_dkv_f32_kernel<D>;
  static bool smem_set[MAX_DEVICES] = {};
  cudaError_t err = allow_smem(kernel, bytes, smem_set);
  if (err != cudaSuccess) return err;
  // the key tile is the slowest grid axis (see the kernels)
  const dim3 grid(p.Hkv, p.B, (p.Sk + keys - 1) / keys);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 16: return dkv ? launch_dkv<T, 16>(p, stream) : launch_dq<T, 16>(p, stream);
    case 32: return dkv ? launch_dkv<T, 32>(p, stream) : launch_dq<T, 32>(p, stream);
    case 64: return dkv ? launch_dkv<T, 64>(p, stream) : launch_dq<T, 64>(p, stream);
    case 80: return dkv ? launch_dkv<T, 80>(p, stream) : launch_dq<T, 80>(p, stream);
    case 120: return dkv ? launch_dkv<T, 120>(p, stream) : launch_dq<T, 120>(p, stream);
    case 128: return dkv ? launch_dkv<T, 128>(p, stream) : launch_dq<T, 128>(p, stream);
    case 256: return dkv ? launch_dkv<T, 256>(p, stream) : launch_dq<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int dtype, int D, bool dkv, void* stream) {
  // the smallest tile is 32 rows: its count is the grid's z extent
  if (p.B <= 0 || p.Hq <= 0 || p.Hkv <= 0 || p.Sq <= 0 || p.Sk <= 0 ||
      p.Hq % p.Hkv != 0 || p.B > 65535 || (p.Sq + 31) / 32 > 65535 ||
      (p.Sk + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(p, D, dkv, s);
    case 1: return (int)dispatch<__nv_bfloat16>(p, D, dkv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  Strides are
// in elements; q, dO (and dq) are Sq rows long, k, v (and dk, dv) Sk rows (the
// wrapper allows Sq != Sk only without a causal or window mask); lse and
// delta are contiguous (B, Hq, Sq) fp32.  Each returns
// the cudaError_t of its launch (0 on success); nothing is synchronised.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    int causal, int window, float scale, void* stream) {
  Params p{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Hq, Hkv, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, dq_sb, dq_sh, dq_ss, 0, 0, 0,
           causal, window, scale};
  return run(p, dtype, D, false, stream);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int causal, int window, float scale, void* stream) {
  Params p{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Hq, Hkv, Sq, Sk,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
           causal, window, scale};
  return run(p, dtype, D, true, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
