// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` of src/repro/kernels/flash_attention.py
// (launched by `_fwd_call`): causal, sliding-window or full GQA attention with
// an online softmax over K/V tiles, writing `out` in the input dtype and the
// per-row `lse = m + log(l)` in fp32 (natural log).  Masked logits are -1e30
// and get probability 0, the softmax is kept in fp32, the scale is 1/sqrt(D)
// and query head h reads kv head h / (Hq / Hkv), all as in the TPU kernel.
// The entry point picks the kernel by dtype:
//
// * bf16 (every serving and training path): `flash_fwd_bf16_kernel`, both
//   products on the tensor cores (mma.sync m16n8k16, fp32 accumulators).
// * fp32 (the card-vs-CPU checks only): `flash_fwd_f32_kernel`, both products
//   on the CUDA cores in fp32.  An fp32 tensor-core product would be TF32,
//   which keeps about three decimal digits.
//
// What bounds it on the H100: at the serving shapes (B 8, S 512, causal,
// bf16) the work is ~4 FLOP a visible (query, key) pair and head dim, 8.6
// GFLOP at 16 heads of 128, against ~67 MB of q/k/v/out: ~8.7 us at the bf16
// tensor-core peak, ~20 us at the memory rate, so memory bounds it.  What the
// bf16 design does about it: each block reads its Q tile once and each K/V
// tile of its horizon once, in 16-byte `cp.async` copies through a two-stage
// ring, so tile j+1 is in flight while tile j is multiplied; the S x S
// scores, the probabilities and the running max and sum never leave
// registers (P is the A operand of the P.V product as it comes out of Q.K^T);
// the output is staged through shared memory and stored in 16-byte rows.
// The tile loop visits only the tiles inside the causal/window horizon (the
// TPU kernel's [lo, hi) range), and the mask is applied only to tiles that
// cross an edge (the diagonal, the window's low edge, the ragged end).
//
// bf16 layout: one block of 4 warps per (q head, batch, query tile of 64
// rows), each warp owning 16 query rows; the query tile is the slowest grid
// axis, so the tiles with the longest causal rows are dispatched first.  K/V tiles are 64 keys (32 at D 256, where the 16 x 256 fp32
// accumulator already takes 128 registers a thread).  Tiles are bf16 in
// shared memory with the XOR swizzle of mma_sm90.cuh.  Q.K^T runs over D
// rounded up to 16: at D 120 columns 120-127 of Q and K are zero-filled by
// the copy, so those k16 steps add exact zeros; P.V covers D / 8 n8 tiles
// (15 at D 120) and only columns below D are written.  The scale and log2(e)
// are applied to the fp32 scores, never to bf16 Q; exponentials are exp2f.
// P is rounded to bf16 for the P.V product (as SDPA does); the row sums are
// taken from the fp32 probabilities.
//
// fp32 layout: one block of 256 threads per (head, batch, query tile), each
// of the 8 warps owning 8 query rows; Q (pre-scaled), K and V tiles in shared
// memory as fp32, P written over the K tile; a lane owns keys lane and
// lane + 32 and the output columns lane + 32 c below D.
//
// Queries and keys may differ in number (Sq and Sk; cross-attention runs
// full, non-causal attention of Sq decoder rows over Sk encoder keys): the
// grid covers the Sq query rows, the tile loop the Sk keys.  Rows past Sq
// and keys past Sk (ragged tails) are loaded as zeros and masked.
// Strides are passed in elements for the batch, head and sequence axes (the
// last axis is contiguous), so the model's (B, S, H, D) layout needs no copy.
// Every row must start on a 16-byte boundary; the Python wrapper checks it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr float NEG_INF = -1e30f;      // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Hq, Hkv, Sq, Sk;              // query and key lengths
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
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
constexpr int STAGES = 2;              // K/V ring depth

template <int D>
struct Tile {
  static_assert(D % 8 == 0 && D <= 256, "head dim: a multiple of 8, at most 256");
  static constexpr int DK = (D + 15) / 16 * 16;          // Q.K^T depth
  static constexpr int KSTEPS = DK / 16;
  static constexpr int NT = D / 8;                       // n8 tiles of out
  static constexpr int QK_CHUNKS = DK / 8;               // copied a Q/K row
  static constexpr int CHUNKS = (QK_CHUNKS + 7) / 8 * 8; // stored a row
  static constexpr int BK = D > 128 ? 32 : 64;           // keys a K/V tile
  static constexpr int SN = BK / 8;                      // n8 tiles of scores
  static constexpr int SMEM = (BQ + 2 * STAGES * BK) * CHUNKS * 16;
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;
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

template <int D>
__global__ void __launch_bounds__(TC_THREADS, Tile<D>::MIN_BLOCKS)
flash_fwd_bf16_kernel(const Params p) {
  using Tl = Tile<D>;
  constexpr int BK = Tl::BK, CH = Tl::CHUNKS, NT = Tl::NT, SN = Tl::SN;

  extern __shared__ uint4 smem[];
  uint4* Qs = smem;                              // BQ rows
  uint4* Ks = Qs + BQ * CH;                      // STAGES x BK rows
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
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // the TPU kernel's tile range [lo, hi) (flash_attention.py:48-57)
  const int nkb = (p.Sk + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + BQ + BK - 1) / BK, nkb) : nkb;
  const int lo = p.window > 0 ? max(floor_div(q0 - p.window + 1, BK), 0) : 0;

  auto load_kv = [&](int kt, int stage) {
    copy_tile<CH>(Ks + stage * BK * CH, kg, p.k_ss, kt * BK, BK,
                  Tl::QK_CHUNKS, NT, p.Sk);
    copy_tile<CH>(Vs + stage * BK * CH, vg, p.v_ss, kt * BK, BK, NT, NT, p.Sk);
  };

  // group 0: Q and the first K/V tile
  copy_tile<CH>(Qs, qg, p.q_ss, q0, BQ, Tl::QK_CHUNKS, NT, p.Sq);
  load_kv(lo, 0);
  sm90::cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max of the raw scores
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  const float sl2 = p.scale * LOG2E;

  for (int kt = lo, it = 0; kt < hi; ++kt, ++it) {
    const int stage = it % STAGES;
    if (kt + 1 < hi) load_kv(kt + 1, (it + 1) % STAGES);
    sm90::cp_async_commit();          // maybe empty: one group an iteration
    sm90::cp_async_wait<1>();         // tile kt (and Q) have landed
    __syncthreads();
    const uint4* ks = Ks + stage * BK * CH;
    const uint4* vs = Vs + stage * BK * CH;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Tl::KSTEPS; ++kk) {
      uint32_t a[4];
      sm90::ldmatrix_x4(a, sm90::smem_addr(
          Qs + sm90::swizzle<CH>(wr + (lane & 15), 2 * kk + (lane >> 4))));
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        uint32_t kb[4];
        sm90::ldmatrix_x4(kb, sm90::smem_addr(
            ks + sm90::swizzle<CH>(n * 8 + (lane & 7) + ((lane >> 4) << 3),
                                   2 * kk + ((lane >> 3) & 1))));
        sm90::mma_bf16_16816(s[n], a, kb[0], kb[1]);
        sm90::mma_bf16_16816(s[n + 1], a, kb[2], kb[3]);
      }
    }

    // the mask, only on tiles that cross an edge for this warp's rows
    const int k0 = kt * BK;
    const int w0 = q0 + wr;
    const bool edge = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > w0) ||
                      (p.window > 0 && k0 <= w0 + 15 - p.window);
    if (edge) {
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(p, e < 2 ? row_a : row_b, k0 + n * 8 + 2 * t + (e & 1)))
            s[n][e] = NEG_INF;
    }

    // online softmax: row max over the quad, rescale, exponentiate
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
      mb[r] = mx[r] * sl2;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = exp2f(fmaf(s[n][e], sl2, -mb[e >> 1]));
        if (edge && s[n][e] == NEG_INF) pe = 0.f;   // masked: probability 0
        s[n][e] = pe;
        rs[e >> 1] += pe;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: two n8 score tiles, packed to bf16, are one k16 A fragment
#pragma unroll
    for (int kk = 0; kk < SN / 2; ++kk) {
      const uint32_t a[4] = {
          sm90::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          sm90::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          sm90::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          sm90::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int vrow = 16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t vb[4];
        sm90::ldmatrix_x4_trans(vb, sm90::smem_addr(
            vs + sm90::swizzle<CH>(vrow, n + (lane >> 4))));
        sm90::mma_bf16_16816(o[n], a, vb[0], vb[1]);
        sm90::mma_bf16_16816(o[n + 1], a, vb[2], vb[3]);
      }
      if constexpr (NT % 2 == 1) {
        uint32_t vb[2];
        sm90::ldmatrix_x2_trans(vb, sm90::smem_addr(
            vs + sm90::swizzle<CH>(vrow, NT - 1)));
        sm90::mma_bf16_16816(o[NT - 1], a, vb[0], vb[1]);
      }
    }
    __syncthreads();                  // this stage is refilled next iteration
  }
  sm90::cp_async_wait<0>();

  // out = acc / l, staged through this warp's own rows of the Q tile (no
  // other warp reads them), then stored 16 bytes a lane
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] + 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t* ra = reinterpret_cast<uint32_t*>(Qs + sm90::swizzle<CH>(wr + g, n));
    uint32_t* rb = reinterpret_cast<uint32_t*>(Qs + sm90::swizzle<CH>(wr + g + 8, n));
    ra[t] = sm90::pack_bf16x2(o[n][0] * inv[0], o[n][1] * inv[0]);
    rb[t] = sm90::pack_bf16x2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb + h * p.o_sh;
  for (int i = lane; i < 16 * NT; i += 32) {
    const int r = i / NT;
    const int c = i % NT;
    const int row = q0 + wr + r;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(og + (long long)row * p.o_ss + c * 8) =
          Qs[sm90::swizzle<CH>(wr + r, c)];
  }
  // lse = m + log(l) in the scaled units, as flash_attention.py:85
  float* lg = p.lse + ((long long)b * p.Hq + h) * p.Sq;
  if (t == 0) {
    if (row_a < p.Sq) lg[row_a] = m[0] * p.scale + logf(l[0] + 1e-30f);
    if (row_b < p.Sq) lg[row_b] = m[1] * p.scale + logf(l[1] + 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BK = 64;                 // keys per K/V tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;       // query rows per warp

// Stage rows [row0, row0 + 64) of one head into shared memory with leading
// dimension LD, times `scale`; rows at or past S become zeros.
template <int D, int LD>
__device__ void load_tile(float* smem, const float* base, long long row_stride,
                          int row0, int S, float scale) {
  constexpr int CPR = D / 4;           // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) {
      a = *reinterpret_cast<const float4*>(base + (long long)(row0 + r) * row_stride + c);
      a.x *= scale; a.y *= scale; a.z *= scale; a.w *= scale;
    }
    *reinterpret_cast<float4*>(smem + r * LD + c) = a;
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

// the K tile (leading dimension D + 4) and, once the logits are taken, P
template <int D>
__host__ __device__ constexpr int kp_floats() {
  return BK * (D + 4) > BQ * BK ? BK * (D + 4) : BQ * BK;
}

template <int D>
constexpr int smem_bytes() {
  return (BQ * D + kp_floats<D>() + BK * D) * (int)sizeof(float);
}

// at D 120 a 128-register budget (two blocks an SM) spills the guarded
// fourth output column; at D 256 the tiles take ~195 KB of shared memory, one
// block an SM
template <int D>
__global__ void __launch_bounds__(THREADS, D == 120 || D > 128 ? 1 : 2)
flash_fwd_f32_kernel(const Params p) {
  constexpr int LDK = D + 4;           // padded: conflict-free 16-byte reads
  constexpr int DPL = (D + 31) / 32;   // output columns per lane, at most

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * D;             // K tile, then P
  float* Vs = Ks + kp_floats<D>();

  const int qt = (int)(gridDim.z - 1 - blockIdx.z);   // longest causal rows first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<D, D>(Qs, qg, p.q_ss, q0, p.Sq, p.scale);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // the TPU kernel's tile range [lo, hi) (flash_attention.py:48-57)
  const int nkb = (p.Sk + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + BQ + BK - 1) / BK, nkb) : nkb;
  const int lo = p.window > 0 ? max(floor_div(q0 - p.window + 1, BK), 0) : 0;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                   // last tile's P and V are consumed
    load_tile<D, LDK>(Ks, kg, p.k_ss, k0, p.Sk, 1.f);
    load_tile<D, D>(Vs, vg, p.v_ss, k0, p.Sk, 1.f);
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
        vis[c] = visible(p, qpos, k0 + lane + 32 * c);
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
  float* og = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
  float* lg = p.lse + ((long long)b * p.Hq + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + r0 + r;
    if (row >= p.Sq) continue;
    const float denom = l[r] + 1e-30f;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < D)
        og[row * p.o_ss + lane + 32 * c] = acc[r][c] / denom;
    if (lane == 0) lg[row] = m[r] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr bool tensor_cores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes = tensor_cores ? Tile<D>::SMEM : smem_bytes<D>();
  constexpr int threads = tensor_cores ? TC_THREADS : THREADS;
  void (*kernel)(const Params) =
      tensor_cores ? &flash_fwd_bf16_kernel<D> : &flash_fwd_f32_kernel<D>;
  // above 48 KB of shared memory, once per instance and device
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  // the query tile is the slowest grid axis: blocks are dispatched in order,
  // so every block of the longest causal rows starts in the first waves
  const dim3 grid(p.Hq, p.B, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 80: return launch<T, 80>(p, stream);
    case 120: return launch<T, 120>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  q is Sq rows
// long, k and v Sk rows (the wrapper allows Sq != Sk only without a causal
// or window mask).  Strides are in elements.  Returns the cudaError_t of the launch (0 on success); nothing
// is synchronised.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hkv != 0 ||
      B > 65535 || (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, lse, B, Hq, Hkv, Sq, Sk,
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
