// Adam for Hopper (sm_90a): the training step's optimizer in two launches.
//
// No TPU kernel to replace: in the JAX package `adam_update`
// (src/repro/optim/adam.py:64-106), `global_norm` and the per-stage squared
// gradient norms (src/repro/core/stages.py) are jnp code that XLA fuses
// inside the jitted step.  PyTorch runs the same arithmetic as about fifteen
// element-wise passes over every parameter; these two kernels are the port's
// counterpart of XLA's fusion.
//
// 1. `adam_sumsq` reads every gradient leaf once.  It gives the sum of
//    squares of each layer of the stacked tower (the stages' omegas are
//    segment sums of these, Alg. 1) and of all leaves together (the global
//    norm for clipping).  The leaves come as a table passed by value, as in
//    stage_merge.cu.  Pass one: each block sums one chunk of one row (a layer
//    of a tower leaf, or a whole leaf) and writes its partial; pass two, one
//    block: each warp sums the partials of whole rows, then fixed loops give
//    the per-layer sums and the total.  Every sum is taken in the same order
//    on every launch and no float atomics are used, so a graph replay and an
//    eager step give the same bits.  Squares are rounded in fp32 (as the
//    plain version squares), sums are kept in fp64.
// 2. `adam_update` makes one pass over (p, g, m, v) of every leaf and writes
//    p, m and v in place.  It reads the clip scale, lr and both bias
//    corrections from device memory (computed on the device from the step
//    counter, optim/adam.py), so nothing of the step is a host number and the
//    launch can be captured in a CUDA graph and replayed.
//
// What bounds them on the H100: memory.  sumsq reads 4 bytes a parameter;
// the update reads p, g, m and v and writes p, m and v, 28 bytes, for about
// 15 operations: ~0.5 operations a byte against the card's ~20 fp32
// operations a byte.  At paper-llama-1.5b's 1.35 B parameters: 32 bytes a
// parameter, 43 GB a step, 12.9 ms at 3.35 TB/s.  What the design does about
// it: 16-byte vector loads and stores where the pointers allow (a scalar loop
// for tails and misaligned leaves), consecutive threads on consecutive
// addresses, and many blocks in flight; nothing is read twice.
//
// Arithmetic follows the plain version (kernels/ref.py `adam_update_ref`)
// step by step: g * scale, m = (1 - b1) g + b1 m and v = (1 - b2) g^2 + b2 v
// with the product b1 m rounded before a fused multiply-add (as PyTorch's
// `mul_` then `add_(alpha=)` on the card), delta = (m / bc1) lr /
// (sqrt(v / bc2) + eps) with IEEE division and square root, plus
// p (lr wd) when weight decay is on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// leaves a launch takes: whisper-large-v3's tree has 33 (layernorms bring a
// bias each); both tables stay under the 4 KB of a kernel's parameters
constexpr int MAX_LEAVES = 64;
constexpr int THREADS = 256;
// elements one block of the sum-of-squares pass reads: 16 float4 a thread
// (kernels/adam.py SUMSQ_CHUNK)
constexpr long long CHUNK = THREADS * 4 * 16;
constexpr int FINAL_THREADS = 1024;
constexpr int MAX_UPDATE_BLOCKS = 1024;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double sq(float x) {
  return static_cast<double>(__fmul_rn(x, x));
}

struct SumsqTable {
  const float* g[MAX_LEAVES];
  long long row_len[MAX_LEAVES];         // elements of one row
  long long first_block[MAX_LEAVES + 1]; // pass-one blocks before leaf i
  int chunks[MAX_LEAVES];                // blocks a row: ceil(row_len / CHUNK)
  int first_seg[MAX_LEAVES + 1];         // rows before leaf i
  int tower[MAX_LEAVES];                 // 1: one row a layer of the tower
  int count;
  int layers;
};

// pass one: partials[b] = sum of squares of block b's chunk of one row
__global__ void __launch_bounds__(THREADS)
sumsq_partials_kernel(const SumsqTable t, double* __restrict__ partials) {
  __shared__ double warp_sums[THREADS / 32];
  const long long b = blockIdx.x;
  int i = 0;
  while (i + 1 < t.count && b >= t.first_block[i + 1]) ++i;
  const long long local = b - t.first_block[i];
  const long long row = local / t.chunks[i];
  const long long row_start = row * t.row_len[i];
  const long long start = row_start + (local - row * t.chunks[i]) * CHUNK;
  const long long end = min(start + CHUNK, row_start + t.row_len[i]);
  const float* g = t.g[i];

  double acc = 0.0;
  long long tail = start;
  if (aligned16(g + start)) {
    const long long nvec = (end - start) / 4;
    const float4* g4 = reinterpret_cast<const float4*>(g + start);
#pragma unroll 4
    for (long long j = threadIdx.x; j < nvec; j += THREADS) {
      const float4 x = g4[j];
      acc += sq(x.x);
      acc += sq(x.y);
      acc += sq(x.z);
      acc += sq(x.w);
    }
    tail = start + nvec * 4;
  }
  for (long long j = tail + threadIdx.x; j < end; j += THREADS) acc += sq(g[j]);

  // the block's sum in a fixed order: within each warp, then across warps
  acc = warp_sum(acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < THREADS / 32 ? warp_sums[lane] : 0.0);
    if (lane == 0) partials[b] = acc;
  }
}

// pass two, one block: row sums, then out[l] = the tower's layer l over its
// leaves (in leaf order) and out[layers] = every row of every leaf
__global__ void __launch_bounds__(FINAL_THREADS)
sumsq_final_kernel(const SumsqTable t, const double* __restrict__ partials,
                   double* __restrict__ rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nrows = t.first_seg[t.count];
  for (int s = warp; s < nrows; s += FINAL_THREADS / 32) {
    int i = 0;
    while (i + 1 < t.count && s >= t.first_seg[i + 1]) ++i;
    const double* p =
        partials + t.first_block[i] + (long long)(s - t.first_seg[i]) * t.chunks[i];
    double acc = 0.0;
    for (int j = lane; j < t.chunks[i]; j += 32) acc += p[j];
    acc = warp_sum(acc);
    if (lane == 0) rows[s] = acc;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < t.layers; l += FINAL_THREADS) {
    double acc = 0.0;
    for (int i = 0; i < t.count; ++i)
      if (t.tower[i]) acc += rows[t.first_seg[i] + l];
    out[l] = static_cast<float>(acc);
  }
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int s = 0; s < nrows; ++s) total += rows[s];
    out[t.layers] = static_cast<float>(total);
  }
}

struct UpdateTable {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  long long n[MAX_LEAVES];
};

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay;
  int clip;
};

struct Scalars {
  float scale, lr, bc1, bc2, lr_wd;
};

__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      const Hyper& h, const Scalars& s) {
  if (h.clip) g = __fmul_rn(g, s.scale);
  m = __fmaf_rn(h.one_minus_b1, g, __fmul_rn(h.b1, m));
  v = __fmaf_rn(h.one_minus_b2, __fmul_rn(g, g), __fmul_rn(h.b2, v));
  float delta = __fdiv_rn(__fmul_rn(__fdiv_rn(m, s.bc1), s.lr),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  if (h.weight_decay > 0.f) delta = __fadd_rn(delta, __fmul_rn(p, s.lr_wd));
  p = __fsub_rn(p, delta);
}

__global__ void __launch_bounds__(THREADS)
adam_update_kernel(const UpdateTable t, const float* __restrict__ scalars,
                   const Hyper h) {
  const int i = blockIdx.y;
  float* p = t.p[i];
  const float* g = t.g[i];
  float* m = t.m[i];
  float* v = t.v[i];
  const long long n = t.n[i];
  Scalars s;
  s.scale = scalars[0];
  s.lr = scalars[1];
  s.bc1 = scalars[2];
  s.bc2 = scalars[3];
  s.lr_wd = __fmul_rn(s.lr, h.weight_decay);
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;

  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  const long long nvec = vec ? n / 4 : 0;
  for (long long j = first; j < nvec; j += stride) {
    float4 pp = reinterpret_cast<const float4*>(p)[j];
    const float4 gg = reinterpret_cast<const float4*>(g)[j];
    float4 mm = reinterpret_cast<const float4*>(m)[j];
    float4 vv = reinterpret_cast<const float4*>(v)[j];
    adam1(pp.x, gg.x, mm.x, vv.x, h, s);
    adam1(pp.y, gg.y, mm.y, vv.y, h, s);
    adam1(pp.z, gg.z, mm.z, vv.z, h, s);
    adam1(pp.w, gg.w, mm.w, vv.w, h, s);
    reinterpret_cast<float4*>(p)[j] = pp;
    reinterpret_cast<float4*>(m)[j] = mm;
    reinterpret_cast<float4*>(v)[j] = vv;
  }
  for (long long j = nvec * 4 + first; j < n; j += stride) {
    float pp = p[j], mm = m[j], vv = v[j];
    adam1(pp, g[j], mm, vv, h, s);
    p[j] = pp;
    m[j] = mm;
    v[j] = vv;
  }
}

}  // namespace

// table: `count` rows of (gradient pointer, elements, rows, tower flag) as
// 64-bit integers, host memory; a leaf of the tower has one row a layer
// (rows == layers), any other leaf one row.  scratch: `scratch_len` fp64 on
// the device, at least the pass-one blocks plus the rows.  out: `layers + 1`
// fp32 on the device (the per-layer sums, then the total).  Returns the
// cudaError_t of the launches (0 on success); nothing is synchronised.
extern "C" int adam_sumsq(const long long* table, int count, int layers,
                          double* scratch, long long scratch_len, float* out,
                          void* stream) {
  if (count <= 0 || count > MAX_LEAVES || layers < 0)
    return (int)cudaErrorInvalidValue;
  SumsqTable t = {};
  t.count = count;
  t.layers = layers;
  long long blocks = 0;
  int nrows = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = table[4 * i + 1], rows = table[4 * i + 2];
    t.g[i] = reinterpret_cast<const float*>(table[4 * i]);
    t.tower[i] = table[4 * i + 3] != 0;
    if (n < 0 || rows < 1 || n % rows != 0 || (t.tower[i] && rows != layers) ||
        (!t.tower[i] && rows != 1))
      return (int)cudaErrorInvalidValue;
    t.row_len[i] = n / rows;
    t.chunks[i] = (int)((t.row_len[i] + CHUNK - 1) / CHUNK);
    t.first_block[i] = blocks;
    t.first_seg[i] = nrows;
    blocks += rows * t.chunks[i];
    nrows += (int)rows;
  }
  t.first_block[count] = blocks;
  t.first_seg[count] = nrows;
  if (blocks > 0x7fffffffLL || scratch_len < blocks + nrows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0)
    sumsq_partials_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(t, scratch);
  sumsq_final_kernel<<<1, FINAL_THREADS, 0, s>>>(t, scratch, scratch + blocks,
                                                 out);
  return (int)cudaGetLastError();
}

// table: `count` rows of (p, g, m, v, elements) as 64-bit integers, host
// memory, all fp32 on the device; scalars: device pointer to fp32
// (clip scale, lr, bc1, bc2).  p, m and v are written in place.  Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
extern "C" int adam_update(const long long* table, int count,
                           const float* scalars, float b1, float b2,
                           float one_minus_b1, float one_minus_b2, float eps,
                           float weight_decay, int clip, void* stream) {
  if (count <= 0 || count > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  UpdateTable t = {};
  long long most = 0;
  for (int i = 0; i < count; ++i) {
    t.p[i] = reinterpret_cast<float*>(table[5 * i]);
    t.g[i] = reinterpret_cast<const float*>(table[5 * i + 1]);
    t.m[i] = reinterpret_cast<float*>(table[5 * i + 2]);
    t.v[i] = reinterpret_cast<float*>(table[5 * i + 3]);
    t.n[i] = table[5 * i + 4];
    if (t.n[i] < 0) return (int)cudaErrorInvalidValue;
    most = t.n[i] > most ? t.n[i] : most;
  }
  const Hyper h = {b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay, clip};
  long long blocks = (most + THREADS * 4 - 1) / (THREADS * 4);
  blocks = blocks < 1 ? 1 : (blocks > MAX_UPDATE_BLOCKS ? MAX_UPDATE_BLOCKS : blocks);
  const dim3 grid((unsigned)blocks, count);
  adam_update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, scalars, h);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
