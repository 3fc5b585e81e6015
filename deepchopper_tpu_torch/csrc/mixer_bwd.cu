// Fused Hyena mixer, backward: recompute the forward, then the gate cotangents
// and the filter-spectrum cotangent summed over the batch.
//
// Replaces the Pallas TPU kernel `_mixer_bwd_kernel` (deepchopper_tpu/ops/pallas_fft.py),
// driven there by `mixer_bwd_pallas`. Same contract, batch-major:
//
//   proj   (B, 3D, L) [x2 | x1 | v] raw in_proj output, float32 or bfloat16
//   dy     (B, D, L)  cotangent of the mixer output, proj's dtype
//   taps   (3, 3D)    float32, tap t multiplies x[n - (2 - t)] (zero for n < 0)
//   bsh    (3D,)      float32 short-conv bias
//   khat   (D, M + 1) complex64, the forward's filter spectrum at N = 2M (1/N and
//                     the skip bias folded in; mixer_fwd.cu)
//   tw     (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   dgates (B, 3D, L) float32 out: [dx2 | dx1 | dv], the cotangents of the
//                     short-convolved gates. They stay float32 (the JAX kernel
//                     rounds them to dy's dtype); the wrapper applies the
//                     short-conv adjoint and casts dproj to proj's dtype.
//   dkhat  (D, M + 1) complex64 out: sum over the batch of conj(X_w[k]) X_dz[k]
//                     (see below), in natural order.
//
// Math, per (row b, channel d), gates short-convolved in float32 as in the
// forward, w = v x1, X_w = rfft_N(w), X_dz = rfft_N(dz):
//   z   = IDFT(khat X_w)[:L]            (the forward's long conv)
//   dx2 = dy z,   dz = dy x2
//   dw  = IDFT(conj(khat) X_dz)[:L]     (circular correlation; exact as N >= 2L)
//   dx1 = dw v,   dv = dw x1
//   dkhat[d, k] += conj(X_w[k]) X_dz[k]
// IDFT is unnormalized (1/N lives in khat). The wrapper turns dkhat into
// (dk_long, dbias) through autograd of the filter spectrum, as the JAX package
// turns its dK into them through jax.vjp(khat_scrambled).
//
// Algorithm. The radix-2 transforms of mixer_fwd.cu (mixer_common.cuh), always in
// the two-half form of its global branch: the packed length-M transform splits
// after its first DIF stage into the even bins (half 0) and the odd bins (half 1),
// each a length-H = M/2 transform held in shared memory (<= 128 KB at N = 65536).
// The real-FFT pairs (k, M - k) have equal parity, so each half is split,
// multiplied and merged on its own, and its inverse is one half of the output
// (z'[m] = E[m] + W_M^-m O[m]). Per row the block runs four such transforms
// (w forward and inverse, dz forward and inverse). X_w is needed again when X_dz
// is known, so the w pass parks its packed spectrum in a global scratch row.
//
// The batch sum without atomics (the result is bitwise repeatable): block
// (g, d) walks rows b = g, g + G, g + 2G, ... of channel d and accumulates into
// its own partial row in global scratch; each bin is always updated by the same
// thread. A second kernel sums the G partials of each channel in the order
// g = 0 .. G-1. G = min(B, max(1, 1024 / D)) keeps about 1024 blocks in flight.
//
// What bounds it on an H100. Bytes: 4 reads (x2, x1, v, dy) and 3 writes
// (dgates, float32) of a (B, D, L) stream, 20 B per token-channel with bfloat16
// inputs, plus the khat row and the partials. Operations: four real FFTs of length N per
// row, about twice the forward's. Like the forward, this first design is bound
// by shared-memory traffic and one __syncthreads per radix-2 stage, not by HBM.
// Higher radix in registers, mixed radix instead of power-of-two padding, and
// keeping X_w in shared memory where it fits are the known ways to close it.

#include <stdint.h>

#include "mixer_common.cuh"

namespace {

using namespace mixer_common;

constexpr int kMaxHalfComplex = 16384;  // 128 KB of float2 per half transform
constexpr int kTargetBlocks = 1024;

struct Args {
  const void* proj;
  const void* dy;
  const float* taps;
  const float* bsh;
  const float2* khat;
  const float2* tw;
  float2* scratch;  // per block: X_w (M) + park (H) + partial (M + 1)
  float* dgates;
  int B;
  int D;
  int L;
  int log2n;
  int groups;
};

__host__ __device__ inline long long block_scratch(int log2n) {
  const long long M = 1ll << (log2n - 1);
  return M + (M >> 1) + (M + 1);
}

// Fill shared memory with half `half` of the packed sequence p[m] = x[2m] +
// i x[2m+1] after the first DIF stage (p is zero for m >= H since L/2 <= H).
template <typename F>
__device__ __forceinline__ void fill_half(float2* s, int H, int half, const float2* tw, F xval) {
  for (int m = threadIdx.x; m < H; m += blockDim.x) {
    float2 z = make_float2(xval(2 * m), xval(2 * m + 1));
    if (half) z = cmul(z, __ldg(&tw[2 * m]));
    s[m] = z;
  }
}

template <typename T>
__global__ void mixer_bwd_kernel(Args a) {
  extern __shared__ float2 s[];
  const int n = 1 << a.log2n;
  const int M = n >> 1;
  const int H = M >> 1;
  const int log2h = a.log2n - 2;
  const int L = a.L;
  const int D = a.D;
  const int c = blockIdx.x % D;
  const int g = blockIdx.x / D;
  const Gate g2(a.taps, a.bsh, D, c), g1(a.taps, a.bsh, D, D + c), gv(a.taps, a.bsh, D, 2 * D + c);
  const float2* kh = a.khat + (size_t)c * (M + 1);
  float2* xw = a.scratch + (size_t)blockIdx.x * block_scratch(a.log2n);
  float2* park = xw + M;
  float2* part = park + H;

  for (int k = threadIdx.x; k <= M; k += blockDim.x) part[k] = make_float2(0.f, 0.f);

  for (int b = g; b < a.B; b += a.groups) {
    const T* proj = static_cast<const T*>(a.proj) + (size_t)b * 3 * D * L;
    const T* x2 = proj + (size_t)c * L;
    const T* x1 = proj + (size_t)(D + c) * L;
    const T* v = proj + (size_t)(2 * D + c) * L;
    const T* dy = static_cast<const T*>(a.dy) + ((size_t)b * D + c) * L;
    float* dx2 = a.dgates + ((size_t)b * 3 * D + c) * L;
    float* dx1 = dx2 + (size_t)D * L;
    float* dv = dx2 + (size_t)2 * D * L;

    // w pass: X_w (parked in xw), z = IDFT(khat X_w), dx2 = dy z.
    for (int half = 0; half < 2; ++half) {
      __syncthreads();
      fill_half(s, H, half, a.tw, [&](int t) { return wval(x1, v, g1, gv, t, L); });
      dif_stages(s, H, H, n, a.tw);
      for (int j = threadIdx.x; 2 * j + half <= (M >> 1); j += blockDim.x) {
        const int k = 2 * j + half;
        const int k2 = (M - k) & (M - 1);
        const int pk = brev(k >> 1, log2h);
        const int pk2 = brev(k2 >> 1, log2h);
        const float2 A = s[pk], Bv = s[pk2];
        xw[half * H + pk] = A;
        xw[half * H + pk2] = Bv;
        float2 za, zb;
        pair_pass(A, Bv, k, M, kh, a.tw, &za, &zb);
        s[pk] = za;
        if (k != 0 && k2 != k) s[pk2] = zb;
      }
      dit_stages(s, H, H, n, a.tw);
      if (half == 0) {
        for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) park[m] = s[m];
      }
    }
    for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) {
      const float2 zz = cadd(park[m], cmul(s[m], cconj(__ldg(&a.tw[2 * m]))));
      dx2[2 * m] = to_f(dy[2 * m]) * zz.x;
      if (2 * m + 1 < L) dx2[2 * m + 1] = to_f(dy[2 * m + 1]) * zz.y;
    }

    // dz pass: X_dz, the partial dkhat, dw = IDFT(conj(khat) X_dz), dx1, dv.
    for (int half = 0; half < 2; ++half) {
      __syncthreads();
      fill_half(s, H, half, a.tw, [&](int t) { return t < L ? to_f(dy[t]) * gate(x2, t, g2) : 0.f; });
      dif_stages(s, H, H, n, a.tw);
      for (int j = threadIdx.x; 2 * j + half <= (M >> 1); j += blockDim.x) {
        const int k = 2 * j + half;
        const int k2 = (M - k) & (M - 1);
        const int pk = brev(k >> 1, log2h);
        const int pk2 = brev(k2 >> 1, log2h);
        float2 dk, dmk, wk, wmk;
        rfft_split(s[pk], s[pk2], k, a.tw, &dk, &dmk);
        rfft_split(xw[half * H + pk], xw[half * H + pk2], k, a.tw, &wk, &wmk);
        part[k] = cadd(part[k], cmul(cconj(wk), dk));
        if (M - k != k) part[M - k] = cadd(part[M - k], cmul(cconj(wmk), dmk));
        float2 za, zb;
        rfft_merge(cmul(dk, cconj(__ldg(&kh[k]))), cmul(dmk, cconj(__ldg(&kh[M - k]))), k, a.tw, &za, &zb);
        s[pk] = za;
        if (k != 0 && k2 != k) s[pk2] = zb;
      }
      dit_stages(s, H, H, n, a.tw);
      if (half == 0) {
        for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) park[m] = s[m];
      }
    }
    for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) {
      const float2 dw = cadd(park[m], cmul(s[m], cconj(__ldg(&a.tw[2 * m]))));
      const int t = 2 * m;
      dx1[t] = dw.x * gate(v, t, gv);
      dv[t] = dw.x * gate(x1, t, g1);
      if (t + 1 < L) {
        dx1[t + 1] = dw.y * gate(v, t + 1, gv);
        dv[t + 1] = dw.y * gate(x1, t + 1, g1);
      }
    }
  }
}

// dkhat[d, k] = sum over g = 0 .. G-1, in that order, of block (g, d)'s partial.
__global__ void mixer_bwd_reduce(const float2* scratch, float2* dkhat, int D, int log2n, int groups) {
  const int M = 1 << (log2n - 1);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)D * (M + 1)) return;
  const int c = (int)(idx / (M + 1));
  const int k = (int)(idx % (M + 1));
  const long long stride = block_scratch(log2n);
  const long long off = M + (M >> 1) + k;  // the partial row inside a block's scratch
  float2 acc = make_float2(0.f, 0.f);
  for (int g = 0; g < groups; ++g) acc = cadd(acc, scratch[(long long)(g * D + c) * stride + off]);
  dkhat[idx] = acc;
}

template <typename T>
cudaError_t launch(const Args& a, float2* dkhat, cudaStream_t stream) {
  const int H = 1 << (a.log2n - 2);
  if (H > kMaxHalfComplex) return cudaErrorInvalidValue;
  const size_t smem = (size_t)H * sizeof(float2);
  int threads = H >> 1;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  cudaError_t err = cudaFuncSetAttribute(mixer_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mixer_bwd_kernel<T><<<a.groups * a.D, threads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)a.D * ((1 << (a.log2n - 1)) + 1);
  mixer_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(a.scratch, dkhat, a.D, a.log2n, a.groups);
  return cudaGetLastError();
}

int groups_for(int B, int D) {
  int g = kTargetBlocks / D;
  if (g < 1) g = 1;
  return g < B ? g : B;
}

}  // namespace

extern "C" {

// Bytes of global scratch the call needs.
long long mixer_bwd_scratch_bytes(int B, int D, int log2n) {
  return (long long)groups_for(B, D) * D * block_scratch(log2n) * (long long)sizeof(float2);
}

// dtype: 0 = float32, 1 = bfloat16 (proj and dy alike). Returns the cudaError_t
// of the launches.
int mixer_bwd(const void* proj, const void* dy, const float* taps, const float* bsh, const void* khat,
              const void* tw, void* scratch, float* dgates, void* dkhat, int B, int D, int L, int log2n, int dtype,
              void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || (1 << log2n) < 2 * L) return (int)cudaErrorInvalidValue;
  Args a{proj, dy, taps, bsh, static_cast<const float2*>(khat), static_cast<const float2*>(tw),
         static_cast<float2*>(scratch), dgates, B, D, L, log2n, groups_for(B, D)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* dk = static_cast<float2*>(dkhat);
  if (dtype == 0) return (int)launch<float>(a, dk, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, dk, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
