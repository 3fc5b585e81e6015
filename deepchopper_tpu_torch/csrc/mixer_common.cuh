// Device code shared by the FFT-conv kernels (mixer_fwd.cu, mixer_bwd.cu,
// mixer_inproj_fwd.cu, conv_fwd.cu): complex helpers, the taps of the gates'
// 3-tap short conv, the mixers' 16-byte chunks of a row, and the split/merge
// that turn a complex length-M transform of a packed real sequence into its
// length-2M real spectrum and back. The transforms themselves are
// fft_radix.cuh's.
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
  __device__ Gate() : k0(0.f), k1(0.f), k2(1.f), b(0.f) {}  // the identity: g[n] = x[n]
  __device__ Gate(const float* taps, const float* bsh, int D, int ch) {
    const int w3 = 3 * D;
    k0 = taps[ch];
    k1 = taps[w3 + ch];
    k2 = taps[2 * w3 + ch];
    b = bsh[ch];
  }
};

// Positions a thread takes at once in the mixers: one 16-byte vector of the dtype.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int P = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int P = 8;
};

__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = u.x;
  x[1] = u.y;
  x[2] = u.z;
  x[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bfloat16 is the top half of its float32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store16(float* p, const float* y) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* y) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(y[2 * i])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(y[2 * i + 1])) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// x[i] = row[n0 + i] for i < P, zero at n >= L.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int n0, int L, bool vec, float* x) {
  constexpr int P = Chunk<T>::P;
  if (vec && n0 + P <= L) {
    load16(row + n0, x);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = n0 + i < L ? to_f(row[n0 + i]) : 0.f;
  }
}

// W_M^m = tw[2m] for the P/2 values m = n0/2 + p of a chunk (m < lim), conjugated or not.
template <int P, bool CONJ>
__device__ __forceinline__ void chunk_twiddles(const float2* tw, int n0, int lim, float2* twm) {
#pragma unroll
  for (int p = 0; p < P / 2; ++p) {
    const int m = n0 / 2 + p;
    const float2 w = m < lim ? __ldg(&tw[2 * m]) : make_float2(0.f, 0.f);
    twm[p] = CONJ ? cconj(w) : w;
  }
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
