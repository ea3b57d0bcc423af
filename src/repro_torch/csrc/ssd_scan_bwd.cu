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
// The entry point picks the walk kernel by dtype, then a second kernel sums
// what the walk left in parts:
//
// * bf16 (every training path): `ssd_bwd_bf16_kernel`, every product on the
//   tensor cores (mma.sync m16n8k16, fp32 accumulators), several blocks a
//   head.
// * fp32 (the card-vs-CPU checks only): `ssd_bwd_f32_kernel`, one block of
//   512 threads per (head, batch), every product in fp32 on the CUDA cores.
// * `ssd_bwd_sum_kernel`: dB and dC of each group from the walk's fp32
//   partials, summed over P blocks, then over the heads of the group, in
//   order; for bf16 also da, the P blocks' d cs partials summed in order and
//   cumsummed from each chunk's end.  No atomics: every sum runs in a fixed
//   order, so two launches give the same bits, and a CUDA graph replays the
//   eager backward exactly.
//
// What bounds it on the H100: at mamba2-1.3b's training shape (B 8, T 512,
// 64 heads of P 64, N 128, one group, bf16) the call reads x, dy, a, B and C
// and writes dx, da, dB and dC, 107 MB (32 us at 3.35 TB/s), and does 38.7
// GFLOP, 39 us at the bf16 tensor-core peak.  The bf16 design adds bytes of
// its own to stay deterministic and small: the recomputed entry states
// (written by the forward walk, read back by the reverse walk, 2 x 134 MB)
// and the fp32 dB and dC partials of each P block (written, then read by the
// summing pass, 4 x 268 MB).  Its in-order chunk walks, each chunk's phases
// behind barriers, bound it further (PERF.md has its time).
//
// bf16 layout: one block per (block of P_BLK = 32 state rows, head,
// batch), the forward's P_BLK, of 8 warps at N 128 (one block an SM, for its
// shared memory) and 4 at N 64 (two an SM).  S and dS are row for row
// independent over P, and every sum over P (dy x^T, x.(dS B), C.(S^T dy),
// dS^T x, S^T dy, <dS, S>) splits into the blocks' parts; each block
// recomputes C B^T, the cheap product every block needs whole.  The block
// holds its P_BLK x N slice of S, then of dS, in fp32 accumulator registers,
// each warp a part of the rows and a quarter of the columns.  Loads are
// `cp.async` copies through a two-stage ring: chunk c - 1 lands while chunk
// c is multiplied.  The forward walk, per chunk: the entry state, split into
// bf16 hi and lo, to the scratch (in the layout the reverse walk copies
// back verbatim); cs as a warp scan (each warp its own copy, times
// log2(e)); x w split into shared memory; S <- 2^cs_L S + (x w)^T B; after
// the last chunk, <dfinal, S>.  The reverse walk, per chunk, three phases
// behind barriers, warp w taking the chunk's tokens [16 (w % 4), +16) and
// (at 8 warps) half of those tokens' tiles and output columns:
// 1. cs; e^cs dy split into shared memory; the copy of dS (split) that the
//    products read.
// 2. The transposed Q x Q tiles of the warp's tokens j (B C^T and x dy^T,
//    rows j, columns i >= j: the tiles left of the diagonal are not
//    computed), the decay on the fragment where i >= j, M's row and column
//    sums; G2^T (and at 8 warps att^T) split into shared memory.
// 3. For tokens j: dx = att^T dy + 2^(cs_L - cs_j) B dS^T, and u; dB =
//    2^(cs_L - cs_j) x dS + G2^T C and dC = e^cs_j dy S + G2 B (G2 through
//    ldmatrix.trans), fp32 parts; C.(S^T dy); after a barrier of the
//    token's warps, this block's d cs of the tokens, an fp32 part.  Then
//    dS <- 2^cs_L dS + (e^cs dy)^T C in the accumulators, and <dS, S> with
//    this chunk's entry state, the state the previous chunk ends in: its
//    last token's d cs takes sum_i u_i + e^cs_L <dS, S_entry> = <dS, S_end>.
// P, N and the chunk are padded to the tile with zeros in shared memory, so
// padded tokens carry nothing and padded rows and columns are not written.
// Rows are copied in 16 bytes where every row starts on a 16-byte boundary,
// else in 8, 4 or 2 (strided views of the model's xBC tensor).
//
// Precision: x, dy, B and C are bf16 already, so C B^T and dy x^T are exact
// up to the order of their fp32 sums.  The six operands formed in fp32 (att,
// G2, dS, the recomputed S, x w and e^cs dy) are each split into a bf16 high
// part and the bf16 rounding of what it leaves, two products each:
// tests/test_torch_ssd_bwd.py emulates these rounding points against the
// float64 plain version within half the gate, 1.5e-2 (1 + |w|), and shows
// for each operand that one bf16 rounding of it misses the gate, 3e-2.
//
// fp32 layout: one block of 512 threads per (head, batch) runs (a), then (b)
// and (c) chunk by chunk: x, dy, B, C, S, dS and the two Q x Q matrices in
// shared memory (205 KB at Q 64, P 64, N 128), each product laying
// consecutive threads on consecutive columns, each thread owning up to 4
// rows and 4 columns strided by the threads' width.  It writes dx and da,
// and dB and dC of its head as fp32 partials.
//
// Inputs: x (B, T, H, P), B and C (B, T, G, N), dy (B, T, H, P) in fp32 or
// bf16 (all one dtype), a (B, T, H) fp32, any strides in elements for the
// batch, token and head (group) axes with the last axis contiguous; init and
// dfinal (B, H, P, N) contiguous fp32 or null (zeros).  Outputs, contiguous:
// dx (B, T, H, P) in x's dtype, da (B, T, H) fp32, dB and dC (B, T, G, N) in
// B's dtype, dinit (B, H, P, N) fp32 or null (not written).  Scratch,
// contiguous fp32: the entry states, (B, H, nc, P, N) for fp32, for bf16
// (B, H, nblk, nc, 32, NT) bf16 hi and lo pairs (nblk = ceil(P / 32), NT = N
// padded to 64 or 128); dB and dC partials (B, T, H, nblk, N), nblk 1 for
// fp32; d cs partials (B, T, H, nblk) (bf16 only).  Launches on the given
// stream, allocates nothing and reads nothing back to the host, so a CUDA
// graph can capture it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int MAX_Q = 64, MAX_P = 64, MAX_N = 128;

struct Params {
  const void* x; const float* a; const void* bm; const void* cm;
  const void* dy; const float* init; const float* dfinal;
  void* dx; float* da; void* db; void* dc; float* dinit;
  void* states; float* dbh; float* dch; float* dcs;
  int B, T, H, G, P, N, chunk, nblk;
  long long x_sb, x_st, x_sh, a_sb, a_st, a_sh, b_sb, b_st, b_sg,
      c_sb, c_st, c_sg, dy_sb, dy_st, dy_sh;
  int x_copy, b_copy, c_copy, dy_copy;   // bytes a copy (bf16 kernel)
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int STAGES = 2;               // load ring depth
constexpr int PB = 32;                  // P_BLK: state rows a block
constexpr int QT = MAX_Q;               // token rows of a chunk tile
constexpr float LOG2E = 1.4426950408889634f;

template <int NT>
struct BwdTile {
  static_assert(NT == 64 || NT == 128, "N is padded to 64 or 128");
  // warps a block of 16 tokens, each taking that share of the columns of
  // dx, dB and dC: 2 at N 128 (8 warps, one block an SM for its shared
  // memory), 1 at N 64 (4 warps, two blocks an SM)
  static constexpr int HALVES = NT / 64;
  static constexpr int WARPS = 4 * HALVES;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int NCH = NT / 8;    // 16-byte chunks of a B, C, S row
  static constexpr int XCH = PB / 8;    // of an x or dy row
  static constexpr int GCH = QT / 8;    // of a G2^T row
  static constexpr int KN = NT / 16;    // k16 steps over N
  static constexpr int KP = PB / 16;    // k16 steps over P
  static constexpr int WNT = NT / 32;   // n8 tiles of S and dS a warp
  static constexpr int NNT = NT / 8;    // n8 tiles of dB and dC
  static constexpr int BC_TILE = QT * NCH;        // uint4s of a B or C tile
  static constexpr int X_TILE = QT * XCH;
  static constexpr int S_TILE = PB * NCH;
  static constexpr int G_TILE = QT * GCH;
  // a ring stage: B, C, x, dy, S hi, S lo
  static constexpr int STAGE = 2 * BC_TILE + 2 * X_TILE + 2 * S_TILE;
  // the ring; e^cs dy (x w in the forward walk), the dS copy, G2^T and (with
  // two parts) att^T, each hi and lo; a per stage, cs per warp, M's row-sum
  // parts per token block, its column sums, u and C.(S^T dy) per part,
  // <dS, S> per warp in two slots
  static constexpr int AT_TILES = HALVES > 1 ? 2 : 0;   // att^T hi, lo
  static constexpr int SMEM =
      (STAGES * STAGE + 2 * X_TILE + 2 * S_TILE + (2 + AT_TILES) * G_TILE) * 16
      + (STAGES * QT + WARPS * QT + 4 * QT + 3 * HALVES * QT + 2 * WARPS) *
            (int)sizeof(float);
};

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// (lo, hi) -> a bf16x2 of their rounding and one of what the rounding left:
// the two products of hi and lo sum to ~16 significant bits
__device__ __forceinline__ void split_bf16x2(float lo, float hi, uint32_t& big,
                                             uint32_t& rest) {
  big = sm90::pack_bf16x2(lo, hi);
  rest = sm90::pack_bf16x2(lo - bf16_lo(big), hi - bf16_hi(big));
}

// B fragments of n8 tiles n0 (b[0], b[1]) and n0 + 1 (b[2], b[3]) for k16
// step k, from a swizzled tile whose rows are n, k contiguous
template <int CH>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const uint4* tile,
                                          int n0, int k, int lane) {
  sm90::ldmatrix_x4(b, sm90::smem_addr(
      tile + sm90::swizzle<CH>(n0 * 8 + (lane & 7) + ((lane >> 4) << 3),
                               2 * k + ((lane >> 3) & 1))));
}

// the same from a tile whose rows are k, n contiguous (ldmatrix.trans)
template <int CH>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const uint4* tile,
                                          int n0, int k, int lane) {
  sm90::ldmatrix_x4_trans(b, sm90::smem_addr(
      tile + sm90::swizzle<CH>(16 * k + (lane & 7) + (((lane >> 3) & 1) << 3),
                               n0 + (lane >> 4))));
}

// the A fragment of m16 tile m, k16 step k, from a tile whose rows are m, k
// contiguous
template <int CH>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const uint4* tile,
                                       int m, int k, int lane) {
  sm90::ldmatrix_x4(a, sm90::smem_addr(
      tile + sm90::swizzle<CH>(16 * m + (lane & 15), 2 * k + (lane >> 4))));
}

// the same from a tile whose rows are k, m contiguous (A transposed)
template <int CH>
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const uint4* tile,
                                         int m, int k, int lane) {
  sm90::ldmatrix_x4_trans(a, sm90::smem_addr(
      tile + sm90::swizzle<CH>(16 * k + (lane & 7) + ((lane >> 4) << 3),
                               2 * m + ((lane >> 3) & 1))));
}

// d[n], d[n + 1] += a times the B fragments b (two n8 tiles)
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  sm90::mma_bf16_16816(d0, a, b[0], b[1]);
  sm90::mma_bf16_16816(d1, a, b[2], b[3]);
}

// rows [0, rows) of a (rows x CH * 8) bf16 tile from rows of `stride`
// elements, BYTES a copy, by THREADS threads; rows at or past valid_rows and
// columns at or past valid_cols are written as zeros.  A thread keeps one
// column and walks rows.
template <int CH, int THREADS, int BYTES>
__device__ __forceinline__ void copy_rows(uint4* tile,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int valid_rows, int valid_cols) {
  constexpr int PER = BYTES / 2;              // elements a copy
  constexpr int UNITS = CH * 8 / PER;         // copies a row
  constexpr int STEP = THREADS / UNITS;       // rows a pass
  static_assert(THREADS % UNITS == 0, "whole rows a pass");
  const int e = (threadIdx.x % UNITS) * PER;
  const bool col_ok = e < valid_cols;
  const __nv_bfloat16* s = src + (threadIdx.x / UNITS) * stride + e;
#pragma unroll 8
  for (int k = 0; k < QT / STEP; ++k, s += STEP * stride) {
    const int r = threadIdx.x / UNITS + k * STEP;
    if (r >= rows) break;
    const bool ok = col_ok && r < valid_rows;
    char* d = reinterpret_cast<char*>(tile + sm90::swizzle<CH>(r, e / 8)) +
              (e % 8) * 2;
    if constexpr (BYTES == 16) {
      sm90::cp_async_16(sm90::smem_addr(d), ok ? s : src, ok);
    } else if constexpr (BYTES == 8) {
      sm90::cp_async_8(sm90::smem_addr(d), ok ? s : src, ok);
    } else if constexpr (BYTES == 4) {
      sm90::cp_async_4(sm90::smem_addr(d), ok ? s : src, ok);
    } else {
      *reinterpret_cast<__nv_bfloat16*>(d) = ok ? *s : __float2bfloat16(0.f);
    }
  }
}

template <int CH, int THREADS>
__device__ __forceinline__ void copy_rows(uint4* tile,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int valid_rows, int valid_cols,
                                          int bytes) {
  switch (bytes) {
    case 16: copy_rows<CH, THREADS, 16>(tile, src, stride, rows, valid_rows, valid_cols); break;
    case 8: copy_rows<CH, THREADS, 8>(tile, src, stride, rows, valid_rows, valid_cols); break;
    case 4: copy_rows<CH, THREADS, 4>(tile, src, stride, rows, valid_rows, valid_cols); break;
    default: copy_rows<CH, THREADS, 2>(tile, src, stride, rows, valid_rows, valid_cols);
  }
}

// cw[t] = log2(e) cs_t, the inclusive cumsum of a chunk's a (0 past its
// end), two tokens a lane, one warp
__device__ __forceinline__ void warp_cumsum(const float* as, float* cw,
                                            int lane) {
  const float a0 = as[2 * lane], a1 = as[2 * lane + 1];
  float s = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
  cw[2 * lane] = (before + a0) * LOG2E;
  cw[2 * lane + 1] = s * LOG2E;
  __syncwarp();
}

// bar.sync on barrier `id` (not 0, which __syncthreads uses) for `threads`
// threads, whole warps
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// v summed over the lanes that differ from this one in the bits from, 2 from,
// ... below to (an xor butterfly: 1, 4 a quad; 4, 32 its column; 1, 32 all)
__device__ __forceinline__ float lanes_sum(float v, int from, int to) {
#pragma unroll
  for (int o = from; o < to; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NT>
__global__ void __launch_bounds__(BwdTile<NT>::THREADS, 3 - BwdTile<NT>::HALVES)
ssd_bwd_bf16_kernel(const Params p) {
  using Tl = BwdTile<NT>;
  constexpr int NCH = Tl::NCH, XCH = Tl::XCH, GCH = Tl::GCH, KN = Tl::KN,
                KP = Tl::KP, WNT = Tl::WNT, HALVES = Tl::HALVES,
                WARPS = Tl::WARPS, THREADS = Tl::THREADS;
  constexpr int MW = 2 / HALVES;                   // m16 tiles of S a warp
  constexpr int HP = 4 / HALVES;                   // n8 tiles of dx a warp
  constexpr int HN = Tl::NNT / HALVES;             // n8 tiles of dB, dC a warp
  using bf16 = __nv_bfloat16;

  extern __shared__ uint4 smem[];
  uint4* ring = smem;                              // STAGES stages
  uint4* EW = ring + STAGES * Tl::STAGE;           // e^cs dy or x w: hi, lo
  uint4* DSc = EW + 2 * Tl::X_TILE;                // the dS copy: hi, lo
  uint4* G2s = DSc + 2 * Tl::S_TILE;               // G2^T (rows j): hi, lo
  uint4* ATs = G2s + 2 * Tl::G_TILE;               // att^T (HALVES > 1)
  float* As = reinterpret_cast<float*>(ATs + Tl::AT_TILES * Tl::G_TILE);
  float* Cw = As + STAGES * QT;                    // log2(e) cs, per warp
  float* ROWP = Cw + WARPS * QT;                   // M's row-sum parts, per
                                                   // token block
  float* COLP = ROWP + 4 * QT;                     // M's column sums, per
                                                   // part
  float* UPART = COLP + HALVES * QT;               // u, per part
  float* VPART = UPART + HALVES * QT;              // C.(S^T dy), per part
  float* RED = VPART + HALVES * QT;                // <dS, S>, 2 x per warp

  const int kblk = blockIdx.x;
  const int p0 = kblk * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pv = min(PB, p.P - p0);                // valid x columns, S rows
  // the state: m16 tiles [MW sm, MW sm + MW), n8 tiles [s0, s0 + WNT)
  const int sm = warp / 4;
  const int s0 = (warp % 4) * WNT;
  // the chunk: tokens [r0, r0 + 16), and part hf of the outputs' columns
  const int tb = warp % 4;
  const int hf = warp / 4;
  const int r0 = 16 * tb;

  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const bf16* dyg =
      static_cast<const bf16*>(p.dy) + b * p.dy_sb + h * p.dy_sh + p0;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const bf16* bg = static_cast<const bf16*>(p.bm) + b * p.b_sb + grp * p.b_sg;
  const bf16* cg = static_cast<const bf16*>(p.cm) + b * p.c_sb + grp * p.c_sg;
  const long long bh = (long long)b * p.H + h;
  const int nc = (p.T + p.chunk - 1) / p.chunk;
  // this block's entry states, one (hi, lo) pair of tiles a chunk
  uint4* states = static_cast<uint4*>(p.states) +
                  (bh * p.nblk + kblk) * nc * 2 * Tl::S_TILE;
  const long long sbase = bh * p.P * p.N;

  // a stage's tiles
  auto Bt = [&](int s) { return ring + s * Tl::STAGE; };
  auto Ct = [&](int s) { return Bt(s) + Tl::BC_TILE; };
  auto Xt = [&](int s) { return Ct(s) + Tl::BC_TILE; };
  auto DYt = [&](int s) { return Xt(s) + Tl::X_TILE; };
  auto St = [&](int s) { return DYt(s) + Tl::X_TILE; };

  // chunk c into stage s: x, B and a; for the reverse walk also dy, C and
  // the chunk's entry state
  auto load = [&](int c, int s, bool reverse) {
    const int t0 = c * p.chunk;
    const int q = min(p.chunk, p.T - t0);
    const int rows = (q + 15) & ~15;
    copy_rows<NCH, THREADS>(Bt(s), bg + t0 * p.b_st, p.b_st, rows, q, p.N,
                            p.b_copy);
    copy_rows<XCH, THREADS>(Xt(s), xg + t0 * p.x_st, p.x_st, rows, q, pv,
                            p.x_copy);
    if (reverse) {
      copy_rows<NCH, THREADS>(Ct(s), cg + t0 * p.c_st, p.c_st, rows, q, p.N,
                              p.c_copy);
      copy_rows<XCH, THREADS>(DYt(s), dyg + t0 * p.dy_st, p.dy_st, rows, q,
                              pv, p.dy_copy);
      const uint4* src = states + (long long)c * 2 * Tl::S_TILE;
      for (int i = threadIdx.x; i < 2 * Tl::S_TILE; i += THREADS)
        sm90::cp_async_16(sm90::smem_addr(St(s) + i), src + i, true);
    }
    for (int j = threadIdx.x; j < QT; j += THREADS) {
      const bool ok = j < q;
      sm90::cp_async_4(sm90::smem_addr(As + s * QT + j),
                       ok ? ag + (long long)(t0 + j) * p.a_st : ag, ok);
    }
  };

  // acc[mt][nt]: S (then dS) rows 16 (MW sm + mt) + g (+ 8), columns
  // 8 (s0 + nt) + 2 t (+ 1)
  float acc[MW][WNT][4];
  auto srow = [&](int mt, int e) { return 16 * (MW * sm + mt) + g + 8 * (e >> 1); };
  // v[mt][nt][e] = src at acc's elements (zero past P and N, or for null)
  auto gather = [&](float (&v)[MW][WNT][4], const float* src) {
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = srow(mt, e);
          const int n = 8 * (s0 + nt) + 2 * t + (e & 1);
          v[mt][nt][e] = src && r < pv && n < p.N
                             ? src[sbase + (long long)(p0 + r) * p.N + n]
                             : 0.f;
        }
  };
  // the accumulators split into bf16 hi and lo tiles (rows p, n contiguous)
  auto store_split = [&](uint4* hi, uint4* lo) {
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = sm90::swizzle<NCH>(srow(mt, 2 * half), s0 + nt);
          split_bf16x2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                       reinterpret_cast<uint32_t*>(hi + i)[t],
                       reinterpret_cast<uint32_t*>(lo + i)[t]);
        }
  };
  // acc <- 2^cl acc + V^T W, V (tokens x P) split in EW, W (tokens x N) a
  // B or C tile: the state update of either walk
  auto update = [&](const uint4* w, int q, float cl) {
    const float dq = exp2f(cl);
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= dq;
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      if (16 * kk >= q) break;
      uint32_t ahi[MW][4], alo[MW][4], vb[WNT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        frag_a_t<XCH>(ahi[mt], EW, MW * sm + mt, kk, lane);
        frag_a_t<XCH>(alo[mt], EW + Tl::X_TILE, MW * sm + mt, kk, lane);
      }
#pragma unroll
      for (int nt = 0; nt < WNT; nt += 2)
        frag_b_kn<NCH>(vb[nt / 2], w, s0 + nt, kk, lane);
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int nt = 0; nt < WNT; nt += 2)
          mma2(acc[mt][nt], acc[mt][nt + 1], ahi[mt], vb[nt / 2]);
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int nt = 0; nt < WNT; nt += 2)
          mma2(acc[mt][nt], acc[mt][nt + 1], alo[mt], vb[nt / 2]);
    }
  };
  // this warp's part of <acc, S>, S split in a (hi, lo) pair of tiles, into
  // slot `slot` of RED
  auto dot_state = [&](const uint4* hi, const uint4* lo, int slot) {
    float dot = 0.f;
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = sm90::swizzle<NCH>(srow(mt, 2 * half), s0 + nt);
          const uint32_t sh = reinterpret_cast<const uint32_t*>(hi + i)[t];
          const uint32_t sl = reinterpret_cast<const uint32_t*>(lo + i)[t];
          dot += acc[mt][nt][2 * half] * (bf16_lo(sh) + bf16_lo(sl)) +
                 acc[mt][nt][2 * half + 1] * (bf16_hi(sh) + bf16_hi(sl));
        }
    dot = lanes_sum(dot, 1, 32);
    if (lane == 0) RED[slot * WARPS + warp] = dot;
  };
  // EW <- the x (or dy) tile times f(token), split into bf16 hi and lo
  auto scale_split = [&](const uint4* src, int q, auto f) {
    const int rows = (q + 15) & ~15;
#pragma unroll
    for (int u = 0; u < QT * PB / 2 / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int j = i / (PB / 2);
      if (j >= rows) break;
      const int e = (i % (PB / 2)) * 2;
      const int k = sm90::swizzle<XCH>(j, e / 8);
      const uint32_t v = reinterpret_cast<const uint32_t*>(src + k)[(e % 8) / 2];
      const float s = f(j);
      split_bf16x2(bf16_lo(v) * s, bf16_hi(v) * s,
                   reinterpret_cast<uint32_t*>(EW + k)[(e % 8) / 2],
                   reinterpret_cast<uint32_t*>(EW + Tl::X_TILE + k)[(e % 8) / 2]);
    }
  };

  float* cw = Cw + warp * QT;

  // ---- (a) the forward walk: each chunk's entry state into the scratch,
  // then the final state's <dfinal, S>
  gather(acc, p.init);
  load(0, 0, false);
  sm90::cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    uint4* dst = states + (long long)c * 2 * Tl::S_TILE;
    store_split(dst, dst + Tl::S_TILE);
    const int q = min(p.chunk, p.T - c * p.chunk);
    const int stage = c % STAGES;
    sm90::cp_async_wait<0>();           // chunk c has landed
    __syncthreads();                    // ... for every thread; chunk c - 1's
                                        // readers of the other slot are done
    if (c + 1 < nc) load(c + 1, (c + 1) % STAGES, false);
    sm90::cp_async_commit();
    warp_cumsum(As + stage * QT, cw, lane);
    const float cl = cw[q - 1];
    scale_split(Xt(stage), q, [&](int j) { return exp2f(cl - cw[j]); });
    __syncthreads();                    // x w is written
    update(Bt(stage), q, cl);
  }
  {
    // the last chunk's d cs takes <dS, S> of the state it ends in: dfinal
    // and the final state
    float df[MW][WNT][4];
    gather(df, p.dfinal);
    float dot = 0.f;
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dot += df[mt][nt][e] * acc[mt][nt][e];
          acc[mt][nt][e] = df[mt][nt][e];
        }
    dot = lanes_sum(dot, 1, 32);
    if (lane == 0) RED[warp] = dot;
  }
  // the entry states are in device memory before any thread copies one back
  __threadfence();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // ---- (b), (c) the reverse walk -----------------------------------------
  load(nc - 1, 0, true);
  sm90::cp_async_commit();
  const long long dx_st = (long long)p.H * p.P;   // a token of dx
  bf16* dxg = static_cast<bf16*>(p.dx) + (long long)b * p.T * dx_st +
              h * p.P + p0;
  const int j0 = r0 + g, j1 = j0 + 8;             // this thread's tokens
  const int n0 = hf * HN;                         // its n8 tiles of dB, dC
  for (int step = 0; step < nc; ++step) {
    const int c = nc - 1 - step;
    const int t0 = c * p.chunk;
    const int q = min(p.chunk, p.T - t0);
    const int stage = step % STAGES;
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (c > 0) load(c - 1, (step + 1) % STAGES, true);
    sm90::cp_async_commit();
    const uint4* bs = Bt(stage);
    const uint4* cs_ = Ct(stage);
    const uint4* xs = Xt(stage);
    const uint4* dys = DYt(stage);
    const uint4* shi = St(stage);
    const uint4* slo = shi + Tl::S_TILE;

    // ---- 1: cs, e^cs dy, the dS copy -------------------------------------
    warp_cumsum(As + stage * QT, cw, lane);
    const float cl = cw[q - 1];
    scale_split(dys, q, [&](int j) { return exp2f(cw[j]); });
    store_split(DSc, DSc + Tl::S_TILE);
    __syncthreads();

    // ---- 2: the transposed Q x Q tiles of tokens j in [r0, r0 + 16)
    // (rows j, columns i in [16 kb, 16 kb + 16), kb >= tb: the tiles left of
    // the diagonal are not computed), part hf of the token block's warps
    // taking the tiles with kb - tb = hf modulo HALVES: B C^T and x dy^T,
    // the decay where i >= j, M's sums, G2^T (and, shared by the parts,
    // att^T) into shared memory
    auto mine = [&](int kb) {
      return kb >= tb && 16 * kb < q && (kb - tb) % HALVES == hf;
    };
    float colsum[2] = {0.f, 0.f};        // sum_{i>j} M_ij, rows g, g + 8
    float t1[4][2][4], t2[4][2][4];      // att^T, G2^T
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t1[kb][n][e] = t2[kb][n][e] = 0.f;
    if (r0 < q) {
      const float cj0 = cw[j0], cj1 = cw[j1];
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        uint32_t ax[4];
        frag_a<XCH>(ax, xs, tb, kp, lane);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          if (!mine(kb)) continue;
          uint32_t vb[4];
          frag_b_nk<XCH>(vb, dys, 2 * kb, kp, lane);
          mma2(t2[kb][0], t2[kb][1], ax, vb);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t ab[4];
        frag_a<NCH>(ab, bs, tb, kk, lane);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          if (!mine(kb)) continue;
          uint32_t vb[4];
          frag_b_nk<NCH>(vb, cs_, 2 * kb, kk, lane);
          mma2(t1[kb][0], t1[kb][1], ab, vb);
        }
      }
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (!mine(kb)) {
          if (hf == 0 && g == 0 && kb < tb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ROWP[tb * QT + 16 * kb + 8 * (e >> 1) + 2 * t + (e & 1)] = 0.f;
          continue;
        }
        float rp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = e < 2 ? j0 : j1;
            const int i = 16 * kb + 8 * n + 2 * t + (e & 1);
            const float d = i >= j ? exp2f(cw[i] - (e < 2 ? cj0 : cj1)) : 0.f;
            const float at = t1[kb][n][e] * d;
            const float m = i > j ? at * t2[kb][n][e] : 0.f;
            colsum[e >> 1] += m;
            rp[n][e & 1] += m;
            t1[kb][n][e] = at;
            t2[kb][n][e] *= d;
          }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = lanes_sum(rp[n][e], 4, 32);
            if (g == 0) ROWP[tb * QT + 16 * kb + 8 * n + 2 * t + e] = v;
          }
        // G2^T (rows j, columns i), split, for dB and dC; att^T too where
        // the parts share it
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = sm90::swizzle<GCH>(r0 + g + 8 * (r & 1),
                                           2 * kb + (r >> 1));
          split_bf16x2(t2[kb][r >> 1][2 * (r & 1)],
                       t2[kb][r >> 1][2 * (r & 1) + 1],
                       reinterpret_cast<uint32_t*>(G2s + i)[t],
                       reinterpret_cast<uint32_t*>(G2s + Tl::G_TILE + i)[t]);
          if constexpr (HALVES > 1)
            split_bf16x2(t1[kb][r >> 1][2 * (r & 1)],
                         t1[kb][r >> 1][2 * (r & 1) + 1],
                         reinterpret_cast<uint32_t*>(ATs + i)[t],
                         reinterpret_cast<uint32_t*>(ATs + Tl::G_TILE + i)[t]);
        }
      }
    } else if (hf == 0 && g == 0) {
      for (int kb = 0; kb < tb; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ROWP[tb * QT + 16 * kb + 8 * (e >> 1) + 2 * t + (e & 1)] = 0.f;
    }
    colsum[0] = lanes_sum(colsum[0], 1, 4);
    colsum[1] = lanes_sum(colsum[1], 1, 4);
    if (t == 0) {
      COLP[hf * QT + j0] = colsum[0];
      COLP[hf * QT + j1] = colsum[1];
    }
    __syncthreads();                    // G2^T and M's sums are in

    // ---- 3: tokens [r0, r0 + 16), part hf of the columns: dx, dB, dC,
    // then (part 0) this block's d cs of the tokens
    if (r0 < q) {
      const float w0 = exp2f(cl - cw[j0]), w1 = exp2f(cl - cw[j1]);
      const float e0 = exp2f(cw[j0]), e1 = exp2f(cw[j1]);
      // dx = att^T dy + w_j dS B_j, and this part's share of u_j =
      // w_j x_j.(dS B_j)
      {
        float xi[HP][4], dxa[HP][4];
#pragma unroll
        for (int n = 0; n < HP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xi[n][e] = dxa[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          uint32_t ab[4], dh[HP / 2][4], dl[HP / 2][4];
          frag_a<NCH>(ab, bs, tb, kk, lane);
#pragma unroll
          for (int n = 0; n < HP; n += 2) {
            frag_b_nk<NCH>(dh[n / 2], DSc, hf * HP + n, kk, lane);
            frag_b_nk<NCH>(dl[n / 2], DSc + Tl::S_TILE, hf * HP + n, kk, lane);
          }
#pragma unroll
          for (int n = 0; n < HP; n += 2) mma2(xi[n], xi[n + 1], ab, dh[n / 2]);
#pragma unroll
          for (int n = 0; n < HP; n += 2) mma2(xi[n], xi[n + 1], ab, dl[n / 2]);
        }
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          if (kb < tb || 16 * kb >= q) continue;
          // att^T: the two n8 tiles, split into bf16 hi and lo, are two k16
          // A fragments (shared by the parts: through shared memory)
          uint32_t ah[4], al[4], vb[HP / 2][4];
          if constexpr (HALVES > 1) {
            frag_a<GCH>(ah, ATs, tb, kb, lane);
            frag_a<GCH>(al, ATs + Tl::G_TILE, tb, kb, lane);
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r)
              split_bf16x2(t1[kb][r >> 1][2 * (r & 1)],
                           t1[kb][r >> 1][2 * (r & 1) + 1], ah[r], al[r]);
          }
#pragma unroll
          for (int n = 0; n < HP; n += 2)
            frag_b_kn<XCH>(vb[n / 2], dys, hf * HP + n, kb, lane);
#pragma unroll
          for (int n = 0; n < HP; n += 2) mma2(dxa[n], dxa[n + 1], ah, vb[n / 2]);
#pragma unroll
          for (int n = 0; n < HP; n += 2) mma2(dxa[n], dxa[n + 1], al, vb[n / 2]);
        }
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int n = 0; n < HP; ++n) {
          const int col = 8 * (hf * HP + n) + 2 * t;
          const uint32_t v0 = reinterpret_cast<const uint32_t*>(
              xs + sm90::swizzle<XCH>(j0, hf * HP + n))[t];
          const uint32_t v1 = reinterpret_cast<const uint32_t*>(
              xs + sm90::swizzle<XCH>(j1, hf * HP + n))[t];
          u0 += bf16_lo(v0) * xi[n][0] + bf16_hi(v0) * xi[n][1];
          u1 += bf16_lo(v1) * xi[n][2] + bf16_hi(v1) * xi[n][3];
          if (col >= pv) continue;
          // dx, bf16 pairs straight from the fragments
          if (j0 < q)
            *reinterpret_cast<uint32_t*>(dxg + (long long)(t0 + j0) * dx_st + col) =
                sm90::pack_bf16x2(dxa[n][0] + w0 * xi[n][0],
                                  dxa[n][1] + w0 * xi[n][1]);
          if (j1 < q)
            *reinterpret_cast<uint32_t*>(dxg + (long long)(t0 + j1) * dx_st + col) =
                sm90::pack_bf16x2(dxa[n][2] + w1 * xi[n][2],
                                  dxa[n][3] + w1 * xi[n][3]);
        }
        u0 = w0 * lanes_sum(u0, 1, 4);
        u1 = w1 * lanes_sum(u1, 1, 4);
        if (t == 0) {
          UPART[hf * QT + j0] = u0;
          UPART[hf * QT + j1] = u1;
        }
      }
      const long long row0 = ((long long)(b * p.T + t0 + j0) * p.H + h) *
                                 p.nblk + kblk;
      const long long row1 = row0 + 8LL * p.H * p.nblk;
      // dB = w_j x_j dS + G2^T C and dC = e^cs_i dy S + G2 B over this
      // part's columns, this block's fp32 parts
      float acc2[HN][4];
      auto clear = [&]() {
#pragma unroll
        for (int n = 0; n < HN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[n][e] = 0.f;
      };
      // acc2 += A V, V (k = P, n) split in a (hi, lo) pair of tiles
      auto times_state = [&](const uint4* a, const uint4* vhi,
                             const uint4* vlo) {
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          uint32_t af[4], vh[HN / 2][4], vl[HN / 2][4];
          frag_a<XCH>(af, a, tb, kp, lane);
#pragma unroll
          for (int n = 0; n < HN; n += 2) {
            frag_b_kn<NCH>(vh[n / 2], vhi, n0 + n, kp, lane);
            frag_b_kn<NCH>(vl[n / 2], vlo, n0 + n, kp, lane);
          }
#pragma unroll
          for (int n = 0; n < HN; n += 2) mma2(acc2[n], acc2[n + 1], af, vh[n / 2]);
#pragma unroll
          for (int n = 0; n < HN; n += 2) mma2(acc2[n], acc2[n + 1], af, vl[n / 2]);
        }
      };
      // acc2 += (A hi + A lo) W over k16 step kb, W a B or C tile
      auto times_tile = [&](const uint32_t (&ah)[4], const uint32_t (&al)[4],
                            const uint4* w, int kb) {
        uint32_t vb[HN / 2][4];
#pragma unroll
        for (int n = 0; n < HN; n += 2)
          frag_b_kn<NCH>(vb[n / 2], w, n0 + n, kb, lane);
#pragma unroll
        for (int n = 0; n < HN; n += 2) mma2(acc2[n], acc2[n + 1], ah, vb[n / 2]);
#pragma unroll
        for (int n = 0; n < HN; n += 2) mma2(acc2[n], acc2[n + 1], al, vb[n / 2]);
      };
      // rows scaled by f0 (g) and f1 (g + 8), then the fp32 part to dst
      auto scale = [&](float f0, float f1) {
#pragma unroll
        for (int n = 0; n < HN; ++n) {
          acc2[n][0] *= f0; acc2[n][1] *= f0;
          acc2[n][2] *= f1; acc2[n][3] *= f1;
        }
      };
      auto store = [&](float* dst) {
#pragma unroll
        for (int n = 0; n < HN; ++n) {
          const int col = 8 * (n0 + n) + 2 * t;
          if (col >= p.N) continue;
          if (j0 < q)
            *reinterpret_cast<float2*>(dst + row0 * p.N + col) =
                make_float2(acc2[n][0], acc2[n][1]);
          if (j1 < q)
            *reinterpret_cast<float2*>(dst + row1 * p.N + col) =
                make_float2(acc2[n][2], acc2[n][3]);
        }
      };
      clear();
      times_state(xs, DSc, DSc + Tl::S_TILE);
      scale(w0, w1);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb < tb || 16 * kb >= q) continue;
        // G2^T (rows j, k = i) as written in phase 2
        uint32_t gh[4], gl[4];
        frag_a<GCH>(gh, G2s, tb, kb, lane);
        frag_a<GCH>(gl, G2s + Tl::G_TILE, tb, kb, lane);
        times_tile(gh, gl, cs_, kb);
      }
      store(p.dbh);
      clear();
      times_state(dys, shi, slo);
      {
        // this part's share of C_i.(S^T dy_i)
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int n = 0; n < HN; ++n) {
          const uint32_t c0 = reinterpret_cast<const uint32_t*>(
              cs_ + sm90::swizzle<NCH>(j0, n0 + n))[t];
          const uint32_t c1 = reinterpret_cast<const uint32_t*>(
              cs_ + sm90::swizzle<NCH>(j1, n0 + n))[t];
          v0 += bf16_lo(c0) * acc2[n][0] + bf16_hi(c0) * acc2[n][1];
          v1 += bf16_lo(c1) * acc2[n][2] + bf16_hi(c1) * acc2[n][3];
        }
        v0 = e0 * lanes_sum(v0, 1, 4);
        v1 = e1 * lanes_sum(v1, 1, 4);
        if (t == 0) {
          VPART[hf * QT + j0] = v0;
          VPART[hf * QT + j1] = v1;
        }
      }
      scale(e0, e1);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb > tb) break;
        // G2 (rows i, k = j) through ldmatrix.trans of G2^T
        uint32_t gh[4], gl[4];
        frag_a_t<GCH>(gh, G2s, tb, kb, lane);
        frag_a_t<GCH>(gl, G2s + Tl::G_TILE, tb, kb, lane);
        times_tile(gh, gl, bs, kb);
      }
      store(p.dch);
      // this block's d cs of the tokens, once every part's u and
      // C.(S^T dy) are in: the last token's takes <dS, S> of the state the
      // chunk ends in (sum_i u_i + 2^cs_L <dS, S_entry>)
      if constexpr (HALVES > 1) bar_sync(1 + tb, 32 * HALVES);
      else __syncwarp();
      if (hf == 0 && t == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? j1 : j0;
          if (i >= q) continue;
          float rows = ROWP[i];
#pragma unroll
          for (int w = 1; w < 4; ++w) rows += ROWP[w * QT + i];
          float v = VPART[i], u = UPART[i];
#pragma unroll
          for (int k = 1; k < HALVES; ++k) {
            v += VPART[k * QT + i];
            u += UPART[k * QT + i];
          }
          float cols = COLP[i];
#pragma unroll
          for (int k = 1; k < HALVES; ++k) cols += COLP[k * QT + i];
          float d = rows - cols + v - u;
          if (i == q - 1) {
            const float* red = RED + (step % 2) * WARPS;
            float dot = red[0];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) dot += red[w];
            d += dot;
          }
          p.dcs[half ? row1 : row0] = d;
        }
      }
    }
    // dS <- 2^cs_L dS + (e^cs dy)^T C, each warp its own part; then
    // <dS, S> for the previous chunk's last token, S this chunk's entry
    // state (the state the previous chunk ends in)
    update(cs_, q, cl);
    if (c > 0) dot_state(shi, slo, (step + 1) % 2);
  }
  sm90::cp_async_wait<0>();

  // dinit, once, in fp32
  if (p.dinit)
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = srow(mt, 2 * half);
          const int n = 8 * (s0 + nt) + 2 * t;
          if (r < pv && n < p.N)
            *reinterpret_cast<float2*>(
                p.dinit + sbase + (long long)(p0 + r) * p.N + n) =
                make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 512;

__host__ __device__ constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// fp32 floats of shared memory for a chunk of Qp (a multiple of 4) tokens;
// x, B and dS rows are padded to an odd stride (conflict-free column reads)
__host__ __device__ constexpr int smem_floats(int qp, int p, int n) {
  return qp * (p + 1) + qp * p + qp * (n + 1) + qp * n + p * n + p * (n + 1)
         + 2 * qp * qp + qp * 32 + 8 * qp + THREADS + 32;
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
// stride pitch), rows [rows, rows_pad) zero
__device__ void load_rows(float* dst, int pitch, const float* src,
                          long long stride, int rows, int rows_pad, int cols) {
  for (int i = threadIdx.x; i < rows_pad * cols; i += THREADS) {
    const int r = i / cols, c = i - r * cols;
    dst[r * pitch + c] = r < rows ? src[r * stride + c] : 0.f;
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

__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_f32_kernel(Params p) {
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

  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dyg =
      static_cast<const float*>(p.dy) + b * p.dy_sb + h * p.dy_sh;
  const float* bg = static_cast<const float*>(p.bm) + b * p.b_sb + g * p.b_sg;
  const float* cg = static_cast<const float*>(p.cm) + b * p.c_sb + g * p.c_sg;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const long long bh = (long long)b * p.H + h;
  float* states = static_cast<float*>(p.states) + bh * nc * P * N;

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
  float* dxg = static_cast<float*>(p.dx);
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

// ---------------------------------------------------------------------------
// the second pass: dB and dC of each group, da (bf16)
// ---------------------------------------------------------------------------

constexpr int SUM_THREADS = 256;

// dB (B, T, G, N) and dC in B's dtype: each head's partials summed over its
// P blocks, then over the heads of its group, in order; with d cs partials,
// da (B, T, H): each token's partials summed over the P blocks in order,
// then cumsummed from the end of its chunk
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_sum_kernel(Params p) {
  const int r = p.H / p.G;
  const int nc = (p.T + p.chunk - 1) / p.chunk;
  const long long quads = (long long)p.B * p.T * p.G * p.N / 4;
  const long long runs = p.dcs ? (long long)p.B * nc * p.H : 0;
  for (long long e = blockIdx.x * (long long)SUM_THREADS + threadIdx.x;
       e < 2 * quads + runs; e += (long long)gridDim.x * SUM_THREADS) {
    if (e < 2 * quads) {
      // four consecutive n of one (b, t, g) of dB or dC; the group's
      // (head, block) parts lie N apart, head by head, loaded eight at a
      // time and summed one by one
      const bool is_c = e >= quads;
      const long long i = (is_c ? e - quads : e) * 4;
      const int n = (int)(i % p.N);
      const long long bt = i / p.N / p.G;          // b * T + t
      const int g = (int)(i / p.N % p.G);
      const float4* src = reinterpret_cast<const float4*>(
          (is_c ? p.dch : p.dbh) + (bt * p.H + g * r) * p.nblk * p.N + n);
      const int m = r * p.nblk;
      float s[4] = {}, sh[4] = {};
      for (int j0 = 0; j0 < m; j0 += 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = j0 + u < m ? src[(long long)(j0 + u) * (p.N / 4)]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u;
          if (j >= m) break;
          const int kb = j % p.nblk;
          const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            sh[k] = kb ? sh[k] + x[k] : x[k];      // over the head's blocks
            if (kb == p.nblk - 1)                  // over heads
              s[k] = j < p.nblk ? sh[k] : s[k] + sh[k];
          }
        }
      }
      T* out = static_cast<T*>(is_c ? p.dc : p.db) + i;
#pragma unroll
      for (int k = 0; k < 4; ++k) st(out + k, s[k]);
    } else {
      const long long i = e - 2 * quads;
      const int h = (int)(i % p.H);
      const int c = (int)(i / p.H % nc);
      const int b = (int)(i / p.H / nc);
      const int t0 = c * p.chunk;
      const int L = min(p.chunk, p.T - t0);
      float s = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        const long long bth = (long long)(b * p.T + t0 + t) * p.H + h;
        const float* part = p.dcs + bth * p.nblk;
        float d = part[0];
        for (int kb = 1; kb < p.nblk; ++kb) d += part[kb];
        s = t == L - 1 ? d : s + d;
        p.da[bth] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// above 48 KB of shared memory, once per kernel and device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_sum(const Params& p, cudaStream_t stream) {
  const int nc = (p.T + p.chunk - 1) / p.chunk;
  const long long items = 2LL * p.B * p.T * p.G * p.N / 4 +
                          (p.dcs ? (long long)p.B * nc * p.H : 0);
  const long long blocks = (items + SUM_THREADS - 1) / SUM_THREADS;
  ssd_bwd_sum_kernel<T>
      <<<(int)(blocks < 4096 ? blocks : 4096), SUM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  constexpr int max_bytes =
      smem_floats(MAX_Q, MAX_P, MAX_N) * (int)sizeof(float);
  cudaError_t err = allow_smem(ssd_bwd_f32_kernel, max_bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int bytes =
      smem_floats(round4(p.chunk), p.P, p.N) * (int)sizeof(float);
  ssd_bwd_f32_kernel<<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum<float>(p, stream);
}

template <int NT>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  constexpr int bytes = BwdTile<NT>::SMEM;
  cudaError_t err = allow_smem(ssd_bwd_bf16_kernel<NT>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  ssd_bwd_bf16_kernel<NT>
      <<<dim3(p.nblk, p.H, p.B), BwdTile<NT>::THREADS, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum<__nv_bfloat16>(p, stream);
}

// the widest copy (16, 8, 4 or 2 bytes) that keeps every row of a bf16
// tensor aligned: the base, each stride of an axis longer than 1 and the
// valid length of a row must be multiples of it
int copy_bytes(const void* base, int valid, long long s0, int n0,
               long long s1, int n1, long long s2, int n2) {
  unsigned long long v = reinterpret_cast<uintptr_t>(base) |
                         (unsigned long long)valid * 2;
  if (n0 > 1) v |= (unsigned long long)s0 * 2;
  if (n1 > 1) v |= (unsigned long long)s1 * 2;
  if (n2 > 1) v |= (unsigned long long)s2 * 2;
  for (int w = 16; w > 2; w /= 2)
    if (v % w == 0) return w;
  return 2;
}

}  // namespace

// dtype of x, B, C, dy, dx, dB and dC: 0 = float32 (CUDA cores), 1 =
// bfloat16 (tensor cores); a, the states and every sum are fp32.  Strides in
// elements (batch, token, head/group axes), the last axis contiguous;
// outputs and scratch are contiguous, shaped as the header says (the bf16
// kernel's for nblk = ceil(P / 32) and N padded to 64 or 128, the fp32
// kernel's for nblk = 1; dcs unused by fp32).  init and dfinal may be null
// (zeros), dinit null (not written).  Returns the cudaError_t of the
// launches (0 on success); nothing is synchronised.
extern "C" int ssd_scan_bwd(
    const void* x, const float* a, const void* bm, const void* cm,
    const void* dy, const float* init, const float* dfinal, void* dx,
    float* da, void* db, void* dc, float* dinit, void* states, float* dbh,
    float* dch, float* dcs, int dtype, int B, int T, int H, int G, int P,
    int N, int chunk, long long x_sb, long long x_st, long long x_sh,
    long long a_sb, long long a_st, long long a_sh,
    long long b_sb, long long b_st, long long b_sg,
    long long c_sb, long long c_st, long long c_sg,
    long long dy_sb, long long dy_st, long long dy_sh, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G != 0 || B > 65535 ||
      H > 65535 || chunk < 1 || chunk > MAX_Q || P < 4 || P > MAX_P ||
      P % 4 != 0 || N < 4 || N > MAX_N || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, a, bm, cm, dy, init, dfinal, dx, da, db, dc, dinit, states,
           dbh, dch, nullptr, B, T, H, G, P, N, chunk, 1,
           x_sb, x_st, x_sh, a_sb, a_st, a_sh, b_sb, b_st, b_sg,
           c_sb, c_st, c_sg, dy_sb, dy_st, dy_sh, 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_f32(p, s);
    case 1: {
      if (dcs == nullptr) return (int)cudaErrorInvalidValue;
      p.dcs = dcs;
      p.nblk = (P + PB - 1) / PB;
      p.x_copy = copy_bytes(x, P, x_sb, B, x_st, T, x_sh, H);
      p.dy_copy = copy_bytes(dy, P, dy_sb, B, dy_st, T, dy_sh, H);
      p.b_copy = copy_bytes(bm, N, b_sb, B, b_st, T, b_sg, G);
      p.c_copy = copy_bytes(cm, N, c_sb, B, c_st, T, c_sg, G);
      return (int)(N > 64 ? launch_bf16<128>(p, s) : launch_bf16<64>(p, s));
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
