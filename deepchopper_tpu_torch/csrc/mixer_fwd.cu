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
// Algorithm. N is the power of two >= 2L, so the linear convolution is exact
// (only rounding differs from the JAX package's mixed-radix N = 2L). The real
// length-N transform runs as a complex length-M transform of z[m] = w[2m] +
// i w[2m+1] (the half-length trick), split once more into two length-H = M/2
// halves: z is zero for m >= L/2 <= H, so the first decimation-in-frequency
// stage needs no reads of the upper half (half 0 = z, half 1 = z * W_M^m), and
// of the inverse's last decimation-in-time stage only the outputs m < L/2 are
// formed. Forward DIF leaves the spectrum in bit-reversed order; the pointwise
// pass (real-FFT split, multiply by khat, real-IFFT merge) addresses it through
// __brev; inverse DIT consumes bit-reversed order and returns natural order.
// No permutation pass is ever run.
//
// Two branches, one block per (batch row, channel):
//   * shared: N <= 32768 (L <= 16384). Both halves (M complex, <= 128 KB) live
//     in shared memory at once.
//   * global: N = 65536 (L = 24576, 32768). One half (H = 16384 complex,
//     128 KB) fits; the block transforms half 0, parks its inverse result E in
//     a per-block global scratch row, then transforms half 1 and merges
//     z'[m] = E[m] + W_M^-m O[m] while it writes the output. The gates x1, v
//     are re-read for half 1 (from L2 in practice).
//
// What bounds it on an H100. Bytes: 3 reads + 1 write of a (B, D, L) stream,
// 8 B per token-channel in bfloat16, plus the khat row per block (L2-resident
// across the batch). Operations: about 5 N log2 N float32 flops per row on the
// CUDA cores (67 TFLOP/s), which at the ladder's widths is the same order as
// the byte bound. This first design is radix-2 in shared memory, so it is
// bound by shared-memory traffic and __syncthreads (one per stage), not by
// HBM: every stage reads and writes the whole row. Measured on an H100 SXM
// (700 W) at the flagship batch shapes it runs at 15-45x the bound, about
// twice as fast as the cuFFT-based plain version (chip_smoke.py, PERF.md).
// Higher radix in registers, mixed radix 2/3/5 in place of the power-of-two
// padding, and tensor-core DFT stages (FlashFFTConv) are the known ways to
// close it.

#include <stdint.h>

#include "mixer_common.cuh"

namespace {

using namespace mixer_common;

constexpr int kMaxSmemComplex = 16384;  // 128 KB of float2

struct Args {
  const void* proj;
  const float* taps;
  const float* bsh;
  const float2* khat;
  const float2* tw;
  float2* scratch;
  void* out;
  int D;
  int L;
  int log2n;
};

template <typename T>
__global__ void mixer_fwd_shared(Args a) {
  extern __shared__ float2 s[];
  const int n = 1 << a.log2n;
  const int M = n >> 1;
  const int H = M >> 1;
  const int log2m = a.log2n - 1;
  const int L = a.L;
  const int D = a.D;
  const int b = blockIdx.x / D;
  const int c = blockIdx.x % D;
  const T* proj = static_cast<const T*>(a.proj);
  const size_t base = (size_t)b * 3 * D * L;
  const T* x2 = proj + base + (size_t)c * L;
  const T* x1 = proj + base + (size_t)(D + c) * L;
  const T* v = proj + base + (size_t)(2 * D + c) * L;
  const Gate g2(a.taps, a.bsh, D, c), g1(a.taps, a.bsh, D, D + c), gv(a.taps, a.bsh, D, 2 * D + c);

  // First DIF stage, folded into the fill: upper half of z is zero.
  for (int m = threadIdx.x; m < H; m += blockDim.x) {
    const float2 z = make_float2(wval(x1, v, g1, gv, 2 * m, L), wval(x1, v, g1, gv, 2 * m + 1, L));
    s[m] = z;
    s[m + H] = cmul(z, __ldg(&a.tw[2 * m]));
  }
  dif_stages(s, M, H, n, a.tw);

  const float2* kh = a.khat + (size_t)c * (M + 1);
  for (int k = threadIdx.x; k <= (M >> 1); k += blockDim.x) {
    const int k2 = (M - k) & (M - 1);
    const int pk = brev(k, log2m);
    const int pk2 = brev(k2, log2m);
    float2 za, zb;
    pair_pass(s[pk], s[pk2], k, M, kh, a.tw, &za, &zb);
    s[pk] = za;
    if (k != 0 && k2 != k) s[pk2] = zb;
  }
  dit_stages(s, M, H, n, a.tw);

  // Last DIT stage (outputs m < L/2 only), then the x2 gate.
  T* out = static_cast<T*>(a.out) + ((size_t)b * D + c) * L;
  for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) {
    const float2 zz = cadd(s[m], cmul(s[m + H], cconj(__ldg(&a.tw[2 * m]))));
    store(&out[2 * m], zz.x * gate(x2, 2 * m, g2));
    if (2 * m + 1 < L) store(&out[2 * m + 1], zz.y * gate(x2, 2 * m + 1, g2));
  }
}

template <typename T>
__global__ void mixer_fwd_global(Args a) {
  extern __shared__ float2 s[];
  const int n = 1 << a.log2n;
  const int M = n >> 1;
  const int H = M >> 1;
  const int log2h = a.log2n - 2;
  const int L = a.L;
  const int D = a.D;
  const int b = blockIdx.x / D;
  const int c = blockIdx.x % D;
  const T* proj = static_cast<const T*>(a.proj);
  const size_t base = (size_t)b * 3 * D * L;
  const T* x2 = proj + base + (size_t)c * L;
  const T* x1 = proj + base + (size_t)(D + c) * L;
  const T* v = proj + base + (size_t)(2 * D + c) * L;
  const Gate g2(a.taps, a.bsh, D, c), g1(a.taps, a.bsh, D, D + c), gv(a.taps, a.bsh, D, 2 * D + c);
  const float2* kh = a.khat + (size_t)c * (M + 1);
  float2* ework = a.scratch + (size_t)blockIdx.x * H;

  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    for (int m = threadIdx.x; m < H; m += blockDim.x) {
      float2 z = make_float2(wval(x1, v, g1, gv, 2 * m, L), wval(x1, v, g1, gv, 2 * m + 1, L));
      if (half) z = cmul(z, __ldg(&a.tw[2 * m]));
      s[m] = z;
    }
    dif_stages(s, H, H, n, a.tw);
    // Pair leaders of this parity class: k = 2j + half, k <= M/2.
    for (int j = threadIdx.x; 2 * j + half <= (M >> 1); j += blockDim.x) {
      const int k = 2 * j + half;
      const int k2 = (M - k) & (M - 1);
      const int pk = brev(k >> 1, log2h);
      const int pk2 = brev(k2 >> 1, log2h);
      float2 za, zb;
      pair_pass(s[pk], s[pk2], k, M, kh, a.tw, &za, &zb);
      s[pk] = za;
      if (k != 0 && k2 != k) s[pk2] = zb;
    }
    dit_stages(s, H, H, n, a.tw);
    if (half == 0) {
      for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) ework[m] = s[m];
    }
  }

  T* out = static_cast<T*>(a.out) + ((size_t)b * D + c) * L;
  for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) {
    const float2 zz = cadd(ework[m], cmul(s[m], cconj(__ldg(&a.tw[2 * m]))));
    store(&out[2 * m], zz.x * gate(x2, 2 * m, g2));
    if (2 * m + 1 < L) store(&out[2 * m + 1], zz.y * gate(x2, 2 * m + 1, g2));
  }
}

template <typename T>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream) {
  const int n = 1 << a.log2n;
  const int M = n >> 1;
  const bool shared = M <= kMaxSmemComplex;
  const int elems = shared ? M : (M >> 1);
  if (elems > kMaxSmemComplex) return cudaErrorInvalidValue;
  const size_t smem = (size_t)elems * sizeof(float2);
  int threads = elems >> 1;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  auto kernel = shared ? mixer_fwd_shared<T> : mixer_fwd_global<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of global scratch the call needs (0 on the shared-memory branch).
long long mixer_fwd_scratch_bytes(int B, int D, int log2n) {
  const long long M = 1ll << (log2n - 1);
  if (M <= kMaxSmemComplex) return 0;
  return (long long)B * D * (M >> 1) * (long long)sizeof(float2);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int mixer_fwd(const void* proj, const float* taps, const float* bsh, const void* khat, const void* tw,
              void* scratch, void* out, int B, int D, int L, int log2n, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || (1 << log2n) < 2 * L) return (int)cudaErrorInvalidValue;
  Args a{proj, taps, bsh, static_cast<const float2*>(khat), static_cast<const float2*>(tw),
         static_cast<float2*>(scratch), out, D, L, log2n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * D;
  if (dtype == 0) return (int)launch<float>(a, rows, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, rows, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
