// Fused Hyena mixer, forward: short conv -> gate -> causal FFT long conv -> gate.
//
// Replaces the Pallas TPU kernel `_mixer_kernel` (deepchopper_tpu/ops/pallas_fft.py),
// entered there through `mixer_fft_conv_bm`. Same contract, batch-major:
//
//   proj  (B, 3D, L) [x2 | x1 | v] raw in_proj output, float32 or bfloat16
//   taps  (3, 3D)    float32, tap t multiplies x[n - (2 - t)] (zero for n < 0)
//   bsh   (3D,)      float32 short-conv bias
//   khat  (D, M + 1) complex64: rfft of the zero-padded long filter at length
//                    N = 2M, with the skip bias folded in as a delta tap and 1/N
//                    applied (computed by the wrapper, as khat_scrambled does)
//   tw    (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   out   (B, D, L)  proj's dtype:  out = (causal_conv(w, k) + w * bias) * x2,
//                    w = v * x1, every gate short-convolved in float32.
//
// A second entry, `gated_fwd`, replaces the Pallas TPU kernels `_gated_kernel`
// and its block-layout twin `_gated_kernel_v2` (pallas_fft.py, entered through
// `gated_fft_conv_cm`; both compute one function and differ only in how a TPU
// tiles it). It is the same function on gates already short-convolved: uc
// (B, 3D, L) [x2 | x1 | v] in place of proj, no taps; w = f32(v) * f32(x1)
// (the Pallas kernels round the product to the input dtype first, which
// bfloat16 I/O shows). It runs the same two kernels instantiated with SHORT
// false, where a gate is a bare chunk load.
//
// Algorithm. N is the power of two >= 2L, so the linear convolution is exact
// (only rounding differs from the JAX package's mixed-radix N = 2L). The real
// length-N transform runs as a complex length-M transform of z[m] = w[2m] +
// i w[2m+1] (the half-length trick), split into two independent length-H = M/2
// transforms: z is zero for m >= L/2 <= H, so half 0 = z and half 1 = z W_M^m
// give Z[2k] and Z[2k+1] with no reads of the upper half. Each half is a
// `fft_radix.cuh` transform: at most four register passes of radix 2-16, in
// natural order, so the pair pass (real-FFT split, times khat, real-IFFT
// merge of bins k and M - k, which share a parity and so a half) addresses the
// spectrum directly. The inverse halves give E and O, and the last stage
// z'[m] = E[m] + W_M^-m O[m] is formed only for m < L/2, straight into the x2
// gate and the output.
//
// Gates. A thread takes 16 bytes of a row at once (8 bfloat16 or 4 float32
// positions), as one vector load of x1, v or x2, and forms the 3-tap short conv
// in registers; the two positions before its chunk come from the lane before
// (__shfl_up_sync), which holds the chunk before, or at a warp's first lane
// from one extra load. Each element of proj is read once per block.
//
// Two kernels:
//   * rows: N <= 32768 (L <= 16384). A block takes G batch rows of one
//     channel, both halves of each in shared memory, with at least 256
//     threads (G = 16 at L = 256 down to 1 from L = 2048); the khat row and
//     the twiddles are read once for all G. A row's arithmetic is the same
//     whichever rows share its block, so every row is bitwise independent of
//     its batch.
//   * pair: N = 65536 (L = 24576, 32768). One row is a cluster of two CTAs:
//     CTA 0 transforms half 0 and CTA 1 half 1, at once, each in its own
//     ~170 KB of shared memory; the pair pass keeps within a half. They meet in
//     the last stage, where each reads the other's half through distributed
//     shared memory after a cluster barrier and writes half of the outputs. No
//     global scratch.
//
// What bounds it on an H100 (both entries). Bytes: 3 reads + 1 write of a
// (B, D, L) stream, 8 B per token-channel in bfloat16, plus the khat row per
// block (L2-resident across the batch). Operations: about 5 N log2 N float32 flops per row on the
// CUDA cores (67 TFLOP/s), the same order as the byte bound at the ladder's
// widths. The radix-2 design before this one was bound by shared-memory
// traffic and a barrier per stage (15-45x its bound); here a transform makes
// 2-4 passes over shared memory where it made 7-14, and on an H100 SXM (700 W)
// the ladder's widths run at 6-20x their bound (chip_smoke.py, PERF.md). Mixed
// radix 2/3/5 in place of the power-of-two padding, fewer registers at V = 32
// (it spills), and tensor-core DFT stages are what is left.

#include <stdint.h>

#include <cooperative_groups.h>

#include "fft_radix.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mixer_common;
using fft_radix::pad;
using fft_radix::padded;
using fft_radix::quarter;
using fft_radix::spectral_pair;

constexpr int kPairLog2h = 14;  // N = 65536: one half fills a CTA's shared memory
constexpr int kMinThreads = 256;
constexpr int kRowsMinBlocks = 4;  // blocks an SM the rows kernel is built for below V = 32
constexpr int kPairThreads = 512;

struct Args {
  const void* proj;
  const float* taps;
  const float* bsh;
  const float2* khat;
  const float2* tw;
  void* out;
  int B;
  int D;
  int L;
  int log2n;
  bool vec_in;   // proj rows start on 16 bytes and L is a whole number of chunks
  bool vec_out;  // the same for out
};

// g[i] = the gate at n0 + i, i < P: with SHORT, short-convolved. The lane
// before holds the chunk n0 - P of the same row, except at a warp's first
// lane and at a row's first chunk, which take the two positions from memory
// (zeros before the row). Every lane of the warp calls it (L = 0 on idle
// lanes). Without SHORT (gated_fwd: uc's gates are convolved already) it is
// the chunk itself.
template <bool SHORT, typename T>
__device__ __forceinline__ void gate_chunk(const T* row, int n0, int L, bool vec, const Gate& gt, float* g) {
  constexpr int P = Chunk<T>::P;
  if constexpr (!SHORT) {
    load_chunk(row, n0, L, vec, g);
  } else {
    float x[P];
    load_chunk(row, n0, L, vec, x);
    float m2 = __shfl_up_sync(0xffffffffu, x[P - 2], 1);
    float m1 = __shfl_up_sync(0xffffffffu, x[P - 1], 1);
    if ((threadIdx.x & 31) == 0 || n0 == 0) {
      m2 = n0 >= 2 && n0 - 2 < L ? to_f(row[n0 - 2]) : 0.f;
      m1 = n0 >= 1 && n0 - 1 < L ? to_f(row[n0 - 1]) : 0.f;
    }
    g[0] = gt.k0 * m2 + gt.k1 * m1 + gt.k2 * x[0] + gt.b;
    g[1] = gt.k0 * m1 + gt.k1 * x[0] + gt.k2 * x[1] + gt.b;
#pragma unroll
    for (int i = 2; i < P; ++i) g[i] = gt.k0 * x[i - 2] + gt.k1 * x[i - 1] + gt.k2 * x[i] + gt.b;
  }
}

// One chunk of z: z[m] = w[2m] + i w[2m+1], w = v * x1 (zero at n >= L), for
// m = n0/2 + p < H, into half 0 (z) and half 1 (z W_M^m); either may be null.
template <bool SHORT, typename T>
__device__ __forceinline__ void fill_chunk(const T* x1, const T* v, int n0, int L, bool vec, const Gate& g1,
                                           const Gate& gv, const float2* twm, int H, float2* h0, float2* h1) {
  constexpr int P = Chunk<T>::P;
  float a[P], b[P];
  gate_chunk<SHORT>(x1, n0, L, vec, g1, a);
  gate_chunk<SHORT>(v, n0, L, vec, gv, b);
  if (L == 0) return;
#pragma unroll
  for (int p = 0; p < P / 2; ++p) {
    const int m = n0 / 2 + p;
    if (m < H) {
      const float2 z = make_float2(n0 + 2 * p < L ? b[2 * p] * a[2 * p] : 0.f,
                                   n0 + 2 * p + 1 < L ? b[2 * p + 1] * a[2 * p + 1] : 0.f);
      if (h0) h0[pad(m)] = z;
      if (h1) h1[pad(m)] = cmul(z, twm[p]);
    }
  }
}

// One chunk of the output: z'[m] = E[m] + conj(W_M^m) O[m] for 2m < L, times
// the x2 gate, stored at n0.. (n < L).
template <bool SHORT, typename T>
__device__ __forceinline__ void out_chunk(const T* x2, T* out, int n0, int L, const Args& a, const Gate& g2,
                                          const float2* e, const float2* o, const float2* twc) {
  constexpr int P = Chunk<T>::P;
  float g[P], y[P];
  gate_chunk<SHORT>(x2, n0, L, a.vec_in, g2, g);
  if (n0 >= L) return;
#pragma unroll
  for (int p = 0; p < P / 2; ++p) {
    const int m = n0 / 2 + p;
    float2 zz = make_float2(0.f, 0.f);
    if (2 * m < L) zz = cadd(e[pad(m)], cmul(o[pad(m)], twc[p]));
    y[2 * p] = zz.x * g[2 * p];
    y[2 * p + 1] = zz.y * g[2 * p + 1];
  }
  if (a.vec_out && n0 + P <= L) {
    store16(out + n0, y);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (n0 + i < L) store(&out[n0 + i], y[i]);
  }
}

// The three gate rows of batch row b, channel c.
template <typename T>
struct Rows {
  const T* x2;
  const T* x1;
  const T* v;
  __device__ Rows(const Args& a, int b, int c) {
    const T* proj = static_cast<const T*>(a.proj) + (size_t)b * 3 * a.D * a.L;
    x2 = proj + (size_t)c * a.L;
    x1 = proj + (size_t)(a.D + c) * a.L;
    v = proj + (size_t)(2 * a.D + c) * a.L;
  }
};

// The taps of gate channel ch, or the identity where the gates come
// convolved (SHORT false: taps and bsh are never read).
template <bool SHORT>
__device__ __forceinline__ Gate gate_of(const Args& a, int ch) {
  if constexpr (SHORT) {
    return Gate(a.taps, a.bsh, a.D, ch);
  } else {
    return Gate();
  }
}

// N <= 32768: G rows of channel c per block, both halves of each row in
// shared memory: [G][2][padded(H)] float2, then the quarter table. The fill,
// the pair pass and the output spread (row, chunk or bin) over all threads.
// 256 threads a block below V = 32 (built for four blocks an SM: a cap of 64
// registers, a few spilled, was faster than 85 or 128), else up to 512.
template <typename T, int V, bool SHORT>
__global__ void __launch_bounds__(V >= 32 ? 512 : 256, V >= 32 ? 1 : kRowsMinBlocks) mixer_fwd_rows(Args a) {
  extern __shared__ float2 s[];
  constexpr int P = Chunk<T>::P;
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  const int L = a.L;
  const int D = a.D;
  const int nt = H / V;  // threads of one transform
  const int G = blockDim.x / (2 * nt);
  const int hp = padded(H);
  float2* wt = s + (size_t)G * 2 * hp;
  const int ng = (a.B + G - 1) / G;
  const int c = blockIdx.x / ng;
  const int b0 = (blockIdx.x % ng) * G;
  const Gate g2 = gate_of<SHORT>(a, c), g1 = gate_of<SHORT>(a, D + c), gv = gate_of<SHORT>(a, 2 * D + c);
  fft_radix::stage_quarter_table(wt, a.tw, H);

  // Chunks of P positions covering [0, 2H) (a power of two, >= L), per row.
  const int log2q = max(0, log2h + 1 - fft_radix::ilog2(P));
  const int items = G << log2q;
  for (int i0 = 0; i0 < items; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int g = i >> log2q, q = i & ((1 << log2q) - 1);
    const int b = b0 + g;
    float2 twm[P / 2];
    chunk_twiddles<P, false>(a.tw, q * P, i < items ? H : 0, twm);
    const Rows<T> r(a, min(b, a.B - 1), c);
    float2* row = s + (size_t)min(g, G - 1) * 2 * hp;
    fill_chunk<SHORT>(r.x1, r.v, q * P, i < items && b < a.B ? L : 0, a.vec_in, g1, gv, twm, H, row, row + hp);
  }
  __syncthreads();

  const int tg = threadIdx.x / (2 * nt);
  const bool active = b0 + tg < a.B;
  float2* x = s + (size_t)(threadIdx.x / nt) * hp;  // row tg, half (threadIdx.x / nt) & 1
  fft_radix::fft<V, false>(x, log2h, threadIdx.x % nt, active, wt);

  // Pairs (k, M - k) for k in [0, H) per row; k = 0 also takes bin H.
  const float2* kh = a.khat + (size_t)c * (M + 1);
  for (int i = threadIdx.x; i < G << log2h; i += blockDim.x) {
    const int g = i >> log2h, k = i & (H - 1);
    if (b0 + g >= a.B) continue;
    float2* row = s + (size_t)g * 2 * hp;
    spectral_pair(row, hp, k, M, kh, a.tw);
    if (k == 0) spectral_pair(row, hp, H, M, kh, a.tw);
  }
  __syncthreads();
  fft_radix::fft<V, true>(x, log2h, threadIdx.x % nt, active, wt);

  for (int i0 = 0; i0 < items; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int g = i >> log2q, q = i & ((1 << log2q) - 1);
    const int b = min(b0 + g, a.B - 1);
    const int Lr = i < items && b0 + g < a.B ? L : 0;
    float2 twc[P / 2];
    chunk_twiddles<P, true>(a.tw, q * P, q * P < Lr ? H : 0, twc);
    const Rows<T> r(a, b, c);
    const float2* row = s + (size_t)min(g, G - 1) * 2 * hp;
    T* out = static_cast<T*>(a.out) + ((size_t)b * D + c) * L;
    out_chunk<SHORT>(r.x2, out, q * P, Lr, a, g2, row, row + hp, twc);
  }
}

// N = 65536: one row per cluster of two CTAs, CTA `rank` holding half `rank`:
// [padded(H)] float2, then the quarter table.
template <typename T, bool SHORT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kPairThreads, 1) mixer_fwd_pair(Args a) {
  extern __shared__ float2 s[];
  constexpr int P = Chunk<T>::P;
  constexpr int V = 32;  // H / V = kPairThreads
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  const int L = a.L;
  const int D = a.D;
  float2* wt = s + padded(H);
  const int b = (blockIdx.x >> 1) / D;
  const int c = (blockIdx.x >> 1) % D;
  const Rows<T> r(a, b, c);
  const Gate g2 = gate_of<SHORT>(a, c), g1 = gate_of<SHORT>(a, D + c), gv = gate_of<SHORT>(a, 2 * D + c);
  fft_radix::stage_quarter_table(wt, a.tw, H);

  const int Q = (2 * H + P - 1) / P;
  for (int q0 = 0; q0 < Q; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    float2 twm[P / 2];
    chunk_twiddles<P, false>(a.tw, q * P, q < Q && rank ? H : 0, twm);
    fill_chunk<SHORT>(r.x1, r.v, q * P, q < Q ? L : 0, a.vec_in, g1, gv, twm, H, rank ? nullptr : s,
                      rank ? s : nullptr);
  }
  __syncthreads();
  fft_radix::fft<V, false>(s, log2h, threadIdx.x, true, wt);

  fft_radix::half_pairs(s, rank, H, a.khat + (size_t)c * (M + 1), a.tw);
  __syncthreads();
  fft_radix::fft<V, true>(s, log2h, threadIdx.x, true, wt);

  // Both halves done: each CTA writes half of the output chunks, reading the
  // other's half through distributed shared memory.
  cluster.sync();
  const float2* other = cluster.map_shared_rank(s, rank ^ 1);
  const float2* e = rank ? other : s;
  const float2* o = rank ? s : other;
  T* out = static_cast<T*>(a.out) + ((size_t)b * D + c) * L;
  const int Qo = (L + P - 1) / P;
  const int Qh = (Qo + 1) / 2;
  const int qend = min(Qo, (rank + 1) * Qh);
  for (int q0 = rank * Qh; q0 < (rank + 1) * Qh; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    float2 twc[P / 2];
    chunk_twiddles<P, true>(a.tw, q * P, q < qend ? H : 0, twc);
    out_chunk<SHORT>(r.x2, out, q * P, q < qend ? L : 0, a, g2, e, o, twc);
  }
  cluster.sync();  // keep this CTA's half alive until the other has read it
}

template <typename T, int V, bool SHORT>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  const int H = 1 << (a.log2n - 2);
  const int nt = H / V;
  const int G = 2 * nt >= kMinThreads ? 1 : kMinThreads / (2 * nt);
  const size_t smem = ((size_t)G * 2 * padded(H) + quarter(H)) * sizeof(float2);
  cudaError_t err =
      cudaFuncSetAttribute(mixer_fwd_rows<T, V, SHORT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mixer_fwd_rows<T, V, SHORT><<<a.D * ((a.B + G - 1) / G), G * 2 * nt, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SHORT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  if (log2h == kPairLog2h) {
    const size_t smem = ((size_t)padded(H) + quarter(H)) * sizeof(float2);
    cudaError_t err =
        cudaFuncSetAttribute(mixer_fwd_pair<T, SHORT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    mixer_fwd_pair<T, SHORT><<<2 * a.B * a.D, kPairThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  switch (fft_radix::values_per_thread(H)) {
    case 2: return launch_rows<T, 2, SHORT>(a, stream);
    case 4: return launch_rows<T, 4, SHORT>(a, stream);
    case 8: return launch_rows<T, 8, SHORT>(a, stream);
    case 16: return launch_rows<T, 16, SHORT>(a, stream);
    default: return launch_rows<T, 32, SHORT>(a, stream);
  }
}

// Both entries: in = proj (SHORT) or uc, (B, 3D, L); dtype 0 = float32, 1 =
// bfloat16. Returns the cudaError_t of the launch.
template <bool SHORT>
int run(const void* in, const float* taps, const float* bsh, const void* khat, const void* tw, void* out, int B, int D,
        int L, int log2n, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > kPairLog2h + 2 || (1 << log2n) < 2 * L || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int P = dtype == 0 ? Chunk<float>::P : Chunk<__nv_bfloat16>::P;
  const bool whole = L % P == 0;
  Args a{in, taps, bsh, static_cast<const float2*>(khat), static_cast<const float2*>(tw), out, B, D, L, log2n,
         whole && ((uintptr_t)in & 15) == 0, whole && ((uintptr_t)out & 15) == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, SHORT>(a, st);
  return (int)launch<__nv_bfloat16, SHORT>(a, st);
}

}  // namespace

extern "C" {

// The fused mixer: proj's gates short-convolved with taps and bsh.
int mixer_fwd(const void* proj, const float* taps, const float* bsh, const void* khat, const void* tw, void* out, int B,
              int D, int L, int log2n, int dtype, void* stream) {
  return run<true>(proj, taps, bsh, khat, tw, out, B, D, L, log2n, dtype, stream);
}

// The gated conv: uc's gates convolved already.
int gated_fwd(const void* uc, const void* khat, const void* tw, void* out, int B, int D, int L, int log2n, int dtype,
              void* stream) {
  return run<false>(uc, nullptr, nullptr, khat, tw, out, B, D, L, log2n, dtype, stream);
}

}  // extern "C"
