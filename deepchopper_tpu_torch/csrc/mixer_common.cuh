// Device code shared by the fused Hyena mixer kernels (mixer_fwd.cu, mixer_bwd.cu):
// complex helpers, the gates' 3-tap short conv, in-place radix-2 FFT stages in
// shared memory, and the split/merge that turn a complex length-M transform of a
// packed real sequence into its length-2M real spectrum and back.
//
// Conventions. N = 2M is the real transform length (a power of two), tw[j] =
// exp(-2 pi i j / N) for j in [0, M]. A real sequence x of length N is packed as
// z[m] = x[2m] + i x[2m+1] (m < M); Z = DFT_M(z) then gives the real spectrum
// X[k], k in [0, M], through rfft_split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mixer_common {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// Taps and bias of one gate channel of the 3-tap causal short conv:
// taps (3, 3D) float32, tap t multiplies x[n - (2 - t)]; bsh (3D,).
struct Gate {
  float k0, k1, k2, b;
  __device__ Gate(const float* taps, const float* bsh, int D, int ch) {
    const int w3 = 3 * D;
    k0 = taps[ch];
    k1 = taps[w3 + ch];
    k2 = taps[2 * w3 + ch];
    b = bsh[ch];
  }
};

// Short-convolved gate value at position n (n < L), float32.
template <typename T>
__device__ __forceinline__ float gate(const T* row, int n, const Gate& g) {
  const float xm2 = n >= 2 ? to_f(row[n - 2]) : 0.f;
  const float xm1 = n >= 1 ? to_f(row[n - 1]) : 0.f;
  return g.k0 * xm2 + g.k1 * xm1 + g.k2 * to_f(row[n]) + g.b;
}

// w[n] = v[n] * x1[n] for n < L, zero beyond.
template <typename T>
__device__ __forceinline__ float wval(const T* x1, const T* v, const Gate& g1, const Gate& gv, int n, int L) {
  if (n >= L) return 0.f;
  return gate(v, n, gv) * gate(x1, n, g1);
}

__device__ __forceinline__ int brev(int x, int bits) {
  return bits ? (int)(__brev((unsigned)x) >> (32 - bits)) : 0;
}

// In-place radix-2 decimation-in-frequency over `size` complex values made of
// independent length-H transforms (natural order in, bit-reversed out).
__device__ inline void dif_stages(float2* s, int size, int H, int n, const float2* tw) {
  for (int span = H >> 1; span >= 1; span >>= 1) {
    __syncthreads();
    const int tstride = n / (2 * span);
    for (int t = threadIdx.x; t < (size >> 1); t += blockDim.x) {
      const int j = t & (span - 1);
      const int i = ((t - j) << 1) + j;
      const float2 a = s[i];
      const float2 b = s[i + span];
      s[i] = cadd(a, b);
      s[i + span] = cmul(csub(a, b), __ldg(&tw[j * tstride]));
    }
  }
  __syncthreads();
}

// In-place radix-2 decimation-in-time inverse (bit-reversed in, natural out),
// unnormalized: the 1/N is folded into the filter spectrum.
__device__ inline void dit_stages(float2* s, int size, int H, int n, const float2* tw) {
  for (int span = 1; span <= (H >> 1); span <<= 1) {
    __syncthreads();
    const int tstride = n / (2 * span);
    for (int t = threadIdx.x; t < (size >> 1); t += blockDim.x) {
      const int j = t & (span - 1);
      const int i = ((t - j) << 1) + j;
      const float2 a = s[i];
      const float2 b = cmul(s[i + span], cconj(__ldg(&tw[j * tstride])));
      s[i] = cadd(a, b);
      s[i + span] = csub(a, b);
    }
  }
  __syncthreads();
}

// Real-FFT split for the pair (k, M-k), k <= M/2: A = Z[k], B = Z[(M-k) mod M]
// -> *xk = X[k], *xmk = X[M-k] (for k = 0, X[0] and X[M]).
__device__ __forceinline__ void rfft_split(float2 A, float2 B, int k, const float2* tw, float2* xk, float2* xmk) {
  const float2 W = __ldg(&tw[k]);  // W_N^k
  // Fe = (A + conj B) / 2, Fo = (A - conj B) / (2i)
  const float2 fe = make_float2(0.5f * (A.x + B.x), 0.5f * (A.y - B.y));
  const float2 fo = make_float2(0.5f * (A.y + B.y), -0.5f * (A.x - B.x));
  const float2 wfo = cmul(W, fo);
  *xk = cadd(fe, wfo);
  *xmk = cconj(csub(fe, wfo));
}

// Real-IFFT merge, the inverse of rfft_split up to the factor 2 of an
// unnormalized transform: Y[k], Y[M-k] -> *pa = Z'[k], *pb = Z'[M-k], so that
// the inverse DFT_M of Z' packs the unnormalized real inverse of Y.
__device__ __forceinline__ void rfft_merge(float2 yk, float2 ymk, int k, const float2* tw, float2* pa, float2* pb) {
  const float2 W = __ldg(&tw[k]);
  // P = Y[k] + conj Y[M-k], Q = Y[k] - conj Y[M-k]
  const float2 P = make_float2(yk.x + ymk.x, yk.y - ymk.y);
  const float2 Q = make_float2(yk.x - ymk.x, yk.y + ymk.y);
  // Z'[k] = P + i conj(W) Q ; Z'[M-k] = conj P + i W conj Q
  const float2 cq = cmul(cconj(W), Q);
  *pa = make_float2(P.x - cq.y, P.y + cq.x);
  const float2 wq = cmul(W, cconj(Q));
  *pb = make_float2(P.x - wq.y, -P.y + wq.x);
}

// Split, filter multiply (kh[k], kh[M-k]) and merge for the pair (k, M-k).
__device__ __forceinline__ void pair_pass(float2 A, float2 B, int k, int M, const float2* kh, const float2* tw,
                                          float2* pa, float2* pb) {
  float2 xk, xmk;
  rfft_split(A, B, k, tw, &xk, &xmk);
  rfft_merge(cmul(xk, __ldg(&kh[k])), cmul(xmk, __ldg(&kh[M - k])), k, tw, pa, pb);
}

}  // namespace mixer_common
