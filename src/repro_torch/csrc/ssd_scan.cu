// Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan.py
// (launched by `ssd_scan`), and adds what the model path takes from
// `ssd_chunked` (src/repro/models/ssm.py): a starting state and the final
// state.  For each (batch, head) the sequence is cut into chunks of Q tokens;
// with cs the inclusive cumsum of the log decay a within the chunk,
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) x_j + exp(cs_i) C_i . S
//   S    <- exp(cs_last) S + sum_j exp(cs_last - cs_j) x_j B_j^T
// where S is the (P, N) fp32 state carried from chunk to chunk.  The entry
// point picks the kernel by dtype:
//
// * bf16 (every serving path): `ssd_scan_bf16_kernel`, every product on the
//   tensor cores (mma.sync m16n8k16, fp32 accumulators).
// * fp32 (the card-vs-CPU checks only): `ssd_scan_f32_kernel`, every product
//   on the CUDA cores in fp32.
//
// What bounds it on the H100: at mamba2-1.3b's serving shape (B 8, T 512,
// 64 heads of P 64, N 128, one group, bf16 x) the call moves 87 MB (x and y,
// fp32 a, B and C, the fp32 final state), 26 us at 3.35 TB/s, and does
// 15 GFLOP, 15 us at the bf16 tensor-core peak: bound by bytes.  What the
// bf16 design does about it: each input is read from device memory once (B
// and C again from L2 by each of a head's blocks and by the other heads of
// their group), y and the state are written once, and the Q x Q matrix and
// the state never leave the block; loads are `cp.async` copies through a
// two-stage ring, so chunk c + 1 is in flight while chunk c is multiplied.
// The kernel stays well above that bound: each block walks its chunks in
// order, and a chunk's phases (loads, cs and x w, y, the state update)
// follow one another behind barriers, so latency rather than the memory or
// the tensor cores sets its time (PERF.md has the per-phase cycle counts).
//
// bf16 layout: one block of 4 warps per (block of P_BLK = 32 state rows,
// head, batch).  The state's P rows are independent and so are y's P
// columns, so the blocks of a head never talk; each walks its head's chunks
// in order, holding its P_BLK x N slice of S in fp32 accumulator registers,
// warp w owning columns [w N/4, (w + 1) N/4).  Per chunk (up to 64 tokens,
// rounded up to 16 with zero rows):
// 1. cs, the inclusive cumsum of a times log2(e), as a warp scan (each warp
//    its own copy); then all threads form x w, w_j = 2^(cs_last - cs_j), and
//    store it split (below) in shared memory.
// 2. y, warp w owning query rows [16 w, 16 w + 16), one key block of 16 at a
//    time up to the diagonal (the blocks above it are not computed): C B^T,
//    the decay 2^(cs_i - cs_j) applied in fp32 on the accumulator fragment
//    (on the diagonal block only where j <= i: above it the decay overflows
//    to inf, as a reaches -1.6 a token with mamba2's parameters; below it as
//    2^(cs_i - cs_r0) 2^(cs_r0 - cs_j), both factors <= 1), and the fragment
//    as the A operand of att x (x through ldmatrix.trans).  The first key
//    block's k loop also runs the inter-chunk term C S^T against the copy of
//    the state the previous chunk left in shared memory.  y is written in
//    bf16 pairs straight from the fragments.
// 3. The state update in the fp32 accumulators: S <- 2^cs_last S +
//    (x w)^T B, (x w)^T read through ldmatrix.trans; then, once every warp
//    has read the old copy, the new copy is written.
// P, N and the chunk are padded to the tile with zeros in shared memory
// (x = B = C = 0, a = 0), so padded tokens carry nothing and padded rows and
// columns are not written.  Rows are copied in 16 bytes where every row
// starts on a 16-byte boundary, else in 8, 4 or 2 (strided views of the
// model's xBC tensor); the wrapper copies nothing.
//
// Precision: x, B and C are bf16 already, so C B^T is exact up to the order
// of its fp32 sums.  The three operands formed in fp32 (att, the state copy,
// x w) are each split into a bf16 high part and the bf16 rounding of what
// the high part leaves, two products each (~16 significant bits): one bf16
// rounding of x w misses the state tolerance 1e-4 more than ten times over
// (tests/test_torch_ssm.py emulates each rounding point and, run as a
// script, prints these errors), and a build that rounds att and the state
// copy once put y 4.5e-2 (1 + |w|) off at mamba2-1.3b's serving shape
// against the 3e-2 tolerance, and zamba2-2.7b's prefill logits over their
// 5% limit (PERF.md).
//
// fp32 layout: one block of 256 threads per (head, batch) walks the chunks,
// x, B^T, C^T, the masked decayed matrix and the state in shared memory as
// fp32 (133 KB at Q 64, P 64, N 128), each product giving every thread 4 x 4
// tiles of its output.
//
// Strides are in elements for the batch, token and head (group) axes; the
// last axis is contiguous.  x, B and C share a dtype (fp32 or bf16); a, the
// states and every sum are fp32; y is written in x's dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

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
  int x_copy, b_copy, c_copy;   // bytes a copy (bf16 kernel)
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;             // one a query row tile of 16
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int STAGES = 2;               // load ring depth
constexpr int PB = 32;                  // P_BLK: state rows a block
constexpr int QT = MAX_Q;               // token rows of a chunk tile
constexpr float LOG2E = 1.4426950408889634f;

template <int NT>
struct Tile {
  static_assert(NT == 64 || NT == 128, "N is padded to 64 or 128");
  static constexpr int NCH = NT / 8;    // 16-byte chunks of a B, C or S row
  static constexpr int XCH = PB / 8;    // of an x row
  static constexpr int KN = NT / 16;    // k16 steps over N
  static constexpr int MT = PB / 16;    // m16 tiles of S
  static constexpr int WNT = NT / 32;   // n8 tiles of S a warp
  static constexpr int YNT = PB / 8;    // n8 tiles of y
  static constexpr int BC_TILE = QT * NCH;        // uint4s of a B or C tile
  static constexpr int X_TILE = QT * XCH;
  static constexpr int S_TILE = PB * NCH;
  // B, C and x rings; x w hi and lo; the state copy hi and lo; a; cs a warp
  static constexpr int SMEM =
      (STAGES * (2 * BC_TILE + X_TILE) + 2 * X_TILE + 2 * S_TILE) * 16
      + (STAGES + TC_WARPS) * QT * (int)sizeof(float);
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

// rows [0, rows) of a (rows x CH * 8) bf16 tile from rows of `stride`
// elements, BYTES a copy; rows at or past valid_rows and columns at or past
// valid_cols are written as zeros.  A thread keeps one column and walks rows.
template <int CH, int BYTES>
__device__ __forceinline__ void copy_rows(uint4* tile,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int valid_rows, int valid_cols) {
  constexpr int PER = BYTES / 2;              // elements a copy
  constexpr int UNITS = CH * 8 / PER;         // copies a row
  constexpr int STEP = TC_THREADS / UNITS;    // rows a pass
  static_assert(TC_THREADS % UNITS == 0, "whole rows a pass");
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

template <int CH>
__device__ __forceinline__ void copy_rows(uint4* tile,
                                          const __nv_bfloat16* src,
                                          long long stride, int rows,
                                          int valid_rows, int valid_cols,
                                          int bytes) {
  switch (bytes) {
    case 16: copy_rows<CH, 16>(tile, src, stride, rows, valid_rows, valid_cols); break;
    case 8: copy_rows<CH, 8>(tile, src, stride, rows, valid_rows, valid_cols); break;
    case 4: copy_rows<CH, 4>(tile, src, stride, rows, valid_rows, valid_cols); break;
    default: copy_rows<CH, 2>(tile, src, stride, rows, valid_rows, valid_cols);
  }
}

template <int NT>
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_scan_bf16_kernel(const Params p) {
  using Tl = Tile<NT>;
  constexpr int NCH = Tl::NCH, XCH = Tl::XCH, MT = Tl::MT, WNT = Tl::WNT,
                YNT = Tl::YNT;

  extern __shared__ uint4 smem[];
  uint4* Bs = smem;                                // STAGES tiles
  uint4* Cs = Bs + STAGES * Tl::BC_TILE;
  uint4* Xs = Cs + STAGES * Tl::BC_TILE;
  uint4* XWs = Xs + STAGES * Tl::X_TILE;           // x w: hi, lo
  uint4* Ss = XWs + 2 * Tl::X_TILE;                // the state copy: hi, lo
  float* As = reinterpret_cast<float*>(Ss + 2 * Tl::S_TILE);
  float* Cw = As + STAGES * QT;                    // log2(e) cs, per warp

  const int p0 = blockIdx.x * PB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int pv = min(PB, p.P - p0);                // valid x columns, S rows
  const int r0 = 16 * warp;                        // this warp's query rows
  const int s0 = warp * WNT;                       // its n8 tiles of S

  using bf16 = __nv_bfloat16;
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const bf16* bg = static_cast<const bf16*>(p.bm) + b * p.b_sb + grp * p.b_sg;
  const bf16* cg = static_cast<const bf16*>(p.cm) + b * p.c_sb + grp * p.c_sg;
  bf16* yg = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh + p0;
  const long long sbase = ((long long)b * p.H + h) * p.P * p.N;

  auto load = [&](int t0, int stage) {
    const int q = min(p.chunk, p.T - t0);
    const int rows = (q + 15) & ~15;
    copy_rows<NCH>(Bs + stage * Tl::BC_TILE, bg + t0 * p.b_st, p.b_st, rows,
                   q, p.N, p.b_copy);
    copy_rows<NCH>(Cs + stage * Tl::BC_TILE, cg + t0 * p.c_st, p.c_st, rows,
                   q, p.N, p.c_copy);
    copy_rows<XCH>(Xs + stage * Tl::X_TILE, xg + t0 * p.x_st, p.x_st, rows,
                   q, pv, p.x_copy);
    for (int j = threadIdx.x; j < QT; j += TC_THREADS) {
      const bool ok = j < q;
      sm90::cp_async_4(sm90::smem_addr(As + stage * QT + j),
                       ok ? ag + (long long)(t0 + j) * p.a_st : ag, ok);
    }
  };

  // the chunk-0 group, then the starting state into the accumulators
  load(0, 0);
  sm90::cp_async_commit();

  // acc[mt][nt]: S rows 16 mt + g (+ 8), columns 8 (s0 + nt) + 2 t (+ 1)
  float acc[MT][WNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + g + 8 * (e >> 1);
        const int n = 8 * (s0 + nt) + 2 * t + (e & 1);
        acc[mt][nt][e] = p.init && r < pv && n < p.N
                             ? p.init[sbase + (long long)(p0 + r) * p.N + n]
                             : 0.f;
      }

  // the copy of S that the inter-chunk term reads: bf16 hi and lo parts
  auto store_state_copy = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = sm90::swizzle<NCH>(16 * mt + g + 8 * half, s0 + nt);
          split_bf16x2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                       reinterpret_cast<uint32_t*>(Ss + i)[t],
                       reinterpret_cast<uint32_t*>(Ss + Tl::S_TILE + i)[t]);
        }
  };
  store_state_copy();

  float* cw = Cw + warp * QT;
  const int nch = (p.T + p.chunk - 1) / p.chunk;
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * p.chunk;
    const int q = min(p.chunk, p.T - t0);
    const int stage = c % STAGES;
    sm90::cp_async_wait<0>();           // chunk c has landed
    __syncthreads();                    // ... for every thread; chunk c - 1's
                                        // readers of this ring slot are done
    if (c + 1 < nch) load(t0 + p.chunk, (c + 1) % STAGES);
    sm90::cp_async_commit();

    const uint4* bs = Bs + stage * Tl::BC_TILE;
    const uint4* cs_ = Cs + stage * Tl::BC_TILE;
    const uint4* xs = Xs + stage * Tl::X_TILE;

    // ---- cs: inclusive cumsum of a, two tokens a lane, times log2(e) ----
    {
      const float* as = As + stage * QT;
      const float a0 = as[2 * lane], a1 = as[2 * lane + 1];   // 0 past q
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
    const float cl = cw[q - 1];

    // ---- x w, w_j = exp(cs_last - cs_j), split into bf16 hi and lo ------
    {
      const int rows = (q + 15) & ~15;
#pragma unroll
      for (int u = 0; u < QT * PB / 2 / TC_THREADS; ++u) {
        const int i = threadIdx.x + u * TC_THREADS;
        const int j = i / (PB / 2);
        if (j >= rows) break;
        const int e = (i % (PB / 2)) * 2;
        const int k = sm90::swizzle<XCH>(j, e / 8);
        const uint32_t xv = reinterpret_cast<const uint32_t*>(xs + k)[(e % 8) / 2];
        const float w = exp2f(cl - cw[j]);
        split_bf16x2(bf16_lo(xv) * w, bf16_hi(xv) * w,
                     reinterpret_cast<uint32_t*>(XWs + k)[(e % 8) / 2],
                     reinterpret_cast<uint32_t*>(XWs + Tl::X_TILE + k)[(e % 8) / 2]);
      }
    }
    __syncthreads();                    // x w is written

    // ---- y for this warp's 16 rows ----------------------------------------
    if (r0 < q) {
      float yi[YNT][4], ye[YNT][4];
#pragma unroll
      for (int n = 0; n < YNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yi[n][e] = ye[n][e] = 0.f;
      const int i0 = r0 + g, i1 = i0 + 8;
      const float ci0 = cw[i0], ci1 = cw[i1];
      const float cr = cw[r0];
      const float d0 = exp2f(ci0 - cr), d1 = exp2f(ci1 - cr);

      // key blocks of 16 up to the diagonal: att = C B^T decayed, then
      // att x; the first block's k loop also runs C S^T
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (16 * kb > r0) break;
        float s[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < Tl::KN; ++kk) {
          uint32_t ac[4], kf[4];
          sm90::ldmatrix_x4(ac, sm90::smem_addr(
              cs_ + sm90::swizzle<NCH>(r0 + (lane & 15), 2 * kk + (lane >> 4))));
          frag_b_nk<NCH>(kf, bs, 2 * kb, kk, lane);
          sm90::mma_bf16_16816(s[0], ac, kf[0], kf[1]);
          sm90::mma_bf16_16816(s[1], ac, kf[2], kf[3]);
          if (kb == 0) {
#pragma unroll
            for (int n = 0; n < YNT; n += 2) {
              uint32_t sh[4], sl[4];
              frag_b_nk<NCH>(sh, Ss, n, kk, lane);
              frag_b_nk<NCH>(sl, Ss + Tl::S_TILE, n, kk, lane);
              sm90::mma_bf16_16816(ye[n], ac, sh[0], sh[1]);
              sm90::mma_bf16_16816(ye[n], ac, sl[0], sl[1]);
              sm90::mma_bf16_16816(ye[n + 1], ac, sh[2], sh[3]);
              sm90::mma_bf16_16816(ye[n + 1], ac, sl[2], sl[3]);
            }
          }
        }
        // the decay where j <= i, zero above the diagonal (rows and keys
        // past q have C = B = 0); below the diagonal block as
        // 2^(cs_i - cs_r0) 2^(cs_r0 - cs_j), both factors <= 1
        if (16 * kb < r0) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dj = exp2f(cr - cw[16 * kb + 8 * n + 2 * t + e]);
              s[n][e] *= d0 * dj;
              s[n][e + 2] *= d1 * dj;
            }
        } else {
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? i0 : i1;
              const int j = 16 * kb + 8 * n + 2 * t + (e & 1);
              s[n][e] = j <= i
                            ? s[n][e] * exp2f((e < 2 ? ci0 : ci1) - cw[j])
                            : 0.f;
            }
        }
        // att x: the two n8 tiles of att, split into bf16 hi and lo, are
        // two k16 A fragments
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16x2(s[r >> 1][2 * (r & 1)], s[r >> 1][2 * (r & 1) + 1],
                       ah[r], al[r]);
#pragma unroll
        for (int n = 0; n < YNT; n += 2) {
          uint32_t vb[4];
          frag_b_kn<XCH>(vb, xs, n, kb, lane);
          sm90::mma_bf16_16816(yi[n], ah, vb[0], vb[1]);
          sm90::mma_bf16_16816(yi[n], al, vb[0], vb[1]);
          sm90::mma_bf16_16816(yi[n + 1], ah, vb[2], vb[3]);
          sm90::mma_bf16_16816(yi[n + 1], al, vb[2], vb[3]);
        }
      }

      // y = att x + exp(cs_i) C S^T, bf16 pairs straight from the fragments
      const float e0 = exp2f(ci0), e1 = exp2f(ci1);
#pragma unroll
      for (int n = 0; n < YNT; ++n) {
        const int col = 8 * n + 2 * t;
        if (col >= pv) continue;
        if (i0 < q)
          *reinterpret_cast<uint32_t*>(yg + (long long)(t0 + i0) * p.y_st + col) =
              sm90::pack_bf16x2(fmaf(e0, ye[n][0], yi[n][0]),
                                fmaf(e0, ye[n][1], yi[n][1]));
        if (i1 < q)
          *reinterpret_cast<uint32_t*>(yg + (long long)(t0 + i1) * p.y_st + col) =
              sm90::pack_bf16x2(fmaf(e1, ye[n][2], yi[n][2]),
                                fmaf(e1, ye[n][3], yi[n][3]));
      }
    }

    // ---- S <- exp(cs_last) S + (x w)^T B, (x w)^T through ldmatrix.trans --
    const float dq = exp2f(cl);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] *= dq;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (16 * kk >= q) break;
      // A = (x w)^T: rows p, columns (k) the chunk's tokens
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int k = sm90::swizzle<XCH>(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                         2 * mt + ((lane >> 3) & 1));
        sm90::ldmatrix_x4_trans(ahi[mt], sm90::smem_addr(XWs + k));
        sm90::ldmatrix_x4_trans(alo[mt], sm90::smem_addr(XWs + Tl::X_TILE + k));
      }
#pragma unroll
      for (int nt = 0; nt < WNT; nt += 2) {
        uint32_t vb[4];
        frag_b_kn<NCH>(vb, bs, s0 + nt, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          sm90::mma_bf16_16816(acc[mt][nt], ahi[mt], vb[0], vb[1]);
          sm90::mma_bf16_16816(acc[mt][nt], alo[mt], vb[0], vb[1]);
          sm90::mma_bf16_16816(acc[mt][nt + 1], ahi[mt], vb[2], vb[3]);
          sm90::mma_bf16_16816(acc[mt][nt + 1], alo[mt], vb[2], vb[3]);
        }
      }
    }
    if (c + 1 < nch) {
      __syncthreads();                  // every warp has read the copy
      store_state_copy();
    }
  }
  sm90::cp_async_wait<0>();

  // the final state, once, in fp32
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
        const int n = 8 * (s0 + nt) + 2 * t;
        if (r < pv && n < p.N)
          *reinterpret_cast<float2*>(
              p.final_state + sbase + (long long)(p0 + r) * p.N + n) =
              make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_f32_kernel(const Params p) {
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

  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* ag = p.a + b * p.a_sb + h * p.a_sh;
  const float* bg = static_cast<const float*>(p.bm) + b * p.b_sb + g * p.b_sg;
  const float* cg = static_cast<const float*>(p.cm) + b * p.c_sb + g * p.c_sg;
  float* yg = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh;
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
      xs[i] = j < q ? xg[(long long)(t0 + j) * p.x_st + pp] : 0.f;
    }
    for (int i = tid; i < q4 * N; i += THREADS) {
      const int j = i / N, n = i % N;
      const long long tb = (long long)(t0 + j);
      bt[n * ldq + j] = j < q ? bg[tb * p.b_st + n] : 0.f;
      ct[n * ldq + j] = j < q ? cg[tb * p.c_st + n] : 0.f;
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
        float* row = yg + (long long)(t0 + i) * p.y_st + 4 * tp;
#pragma unroll
        for (int c = 0; c < 4; ++c) row[c] = intra[r][c] + e * inter[r][c];
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

cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  constexpr int max_bytes =
      smem_floats(MAX_Q, MAX_P, MAX_N) * (int)sizeof(float);
  cudaError_t err = allow_smem(ssd_scan_f32_kernel, max_bytes, smem_set);
  if (err != cudaSuccess) return err;
  const int bytes = smem_floats(round4(p.chunk), p.P, p.N) * (int)sizeof(float);
  ssd_scan_f32_kernel<<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static bool smem_set[MAX_DEVICES] = {};
  constexpr int bytes = Tile<NT>::SMEM;
  cudaError_t err = allow_smem(ssd_scan_bf16_kernel<NT>, bytes, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.P + PB - 1) / PB, p.H, p.B);
  ssd_scan_bf16_kernel<NT><<<grid, TC_THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
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

// dtype of x, B, C and y: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores); a and the states are fp32.  x (B, T, H, P), a (B, T, H), bm/cm
// (B, T, G, N), y (B, T, H, P); strides in elements, the last axis
// contiguous.  init may be null (zeros).  Returns the cudaError_t of the
// launch (0 on success); nothing is synchronised.
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
      H > 65535 || chunk < 1 || chunk > MAX_Q || P < 4 || P > MAX_P ||
      P % 4 != 0 || N < 4 || N > MAX_N || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, a, bm, cm, init, y, final_state, B, T, H, G, P, N, chunk,
           x_sb, x_st, x_sh, a_sb, a_st, a_sh, b_sb, b_st, b_sg,
           c_sb, c_st, c_sg, y_sb, y_st, y_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_f32(p, s);
    case 1: {
      p.x_copy = copy_bytes(x, P, x_sb, B, x_st, T, x_sh, H);
      p.b_copy = copy_bytes(bm, N, b_sb, B, b_st, T, b_sg, G);
      p.c_copy = copy_bytes(cm, N, c_sb, B, c_st, T, c_sg, G);
      // y is written in bf16 pairs
      if (copy_bytes(y, P, y_sb, B, y_st, T, y_sh, H) < 4)
        return (int)cudaErrorInvalidValue;
      return (int)(N > 64 ? launch_bf16<128>(p, s) : launch_bf16<64>(p, s));
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
