// Causal FFT long conv of one row, shared by gated_fwd.cu and conv_fwd.cu: the
// two radix-2 branches of the first mixer_fwd.cu (shared memory for N <=
// 32768, two halves through a global scratch row for N = 65536) with the fill
// and the output written by the caller, so each kernel supplies only how it
// forms w and what it does with z. mixer_fwd.cu and mixer_inproj_fwd.cu run on
// fft_radix.cuh instead.
//
// Conventions as in mixer_common.cuh: N = 2M = 4H, the power of two >= 2L; z[m] =
// w[2m] + i w[2m+1] is zero for m >= ceil(L/2) <= H; khat (M + 1) complex per
// channel already holds 1/N and the skip bias. Every function is called by all
// threads of the block.

#pragma once

#include "mixer_common.cuh"

namespace fftconv {

using namespace mixer_common;

constexpr int kMaxSmemComplex = 16384;  // 128 KB of float2
constexpr int kMaxSmemBytes = 232448;   // what a block may use on sm_90

// The branch a width takes: true = the whole length-M row in shared memory.
__host__ __device__ inline bool shared_branch(int log2n) { return (1 << (log2n - 1)) <= kMaxSmemComplex; }

// Shared branch, fill: s[m] = z[m] and s[m + H] = z[m] W_M^m (the first DIF stage;
// the upper half of z is zero). pair(m) returns z[m] for m < H.
template <class Pair>
__device__ void fill_shared(float2* s, int log2n, const float2* tw, Pair pair) {
  const int H = 1 << (log2n - 2);
  for (int m = threadIdx.x; m < H; m += blockDim.x) {
    const float2 z = pair(m);
    s[m] = z;
    s[m + H] = cmul(z, __ldg(&tw[2 * m]));
  }
}

// Shared branch after the fill: forward DIF, the pointwise filter pass on the
// bit-reversed spectrum, inverse DIT. s then holds both halves of the inverse.
__device__ inline void core_shared(float2* s, int log2n, const float2* kh, const float2* tw) {
  const int n = 1 << log2n;
  const int M = n >> 1;
  const int H = M >> 1;
  const int log2m = log2n - 1;
  dif_stages(s, M, H, n, tw);
  for (int k = threadIdx.x; k <= (M >> 1); k += blockDim.x) {
    const int k2 = (M - k) & (M - 1);
    const int pk = brev(k, log2m);
    const int pk2 = brev(k2, log2m);
    float2 za, zb;
    pair_pass(s[pk], s[pk2], k, M, kh, tw, &za, &zb);
    s[pk] = za;
    if (k != 0 && k2 != k) s[pk2] = zb;
  }
  dit_stages(s, M, H, n, tw);
}

// Shared branch, output: the last DIT stage for m < L/2; emit(n, y) gets
// y = causal_conv(w, k)[n] + w[n] * bias for every n < L.
template <class Emit>
__device__ void emit_shared(const float2* s, int log2n, int L, const float2* tw, Emit emit) {
  const int H = 1 << (log2n - 2);
  for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) {
    const float2 zz = cadd(s[m], cmul(s[m + H], cconj(__ldg(&tw[2 * m]))));
    emit(2 * m, zz.x);
    if (2 * m + 1 < L) emit(2 * m + 1, zz.y);
  }
}

// Global branch (N = 65536): half 0 (z) and half 1 (z W_M^m) each transformed
// in the H-complex shared buffer; half 0's inverse is parked in ework (H
// complex of global scratch). pair(m) is called twice for every m < H. On
// return s holds half 1's inverse.
template <class Pair>
__device__ void core_global(float2* s, float2* ework, int log2n, int L, const float2* kh, const float2* tw,
                            Pair pair) {
  const int n = 1 << log2n;
  const int M = n >> 1;
  const int H = M >> 1;
  const int log2h = log2n - 2;
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    for (int m = threadIdx.x; m < H; m += blockDim.x) {
      float2 z = pair(m);
      if (half) z = cmul(z, __ldg(&tw[2 * m]));
      s[m] = z;
    }
    dif_stages(s, H, H, n, tw);
    // Pair leaders of this parity class: k = 2j + half, k <= M/2.
    for (int j = threadIdx.x; 2 * j + half <= (M >> 1); j += blockDim.x) {
      const int k = 2 * j + half;
      const int k2 = (M - k) & (M - 1);
      const int pk = brev(k >> 1, log2h);
      const int pk2 = brev(k2 >> 1, log2h);
      float2 za, zb;
      pair_pass(s[pk], s[pk2], k, M, kh, tw, &za, &zb);
      s[pk] = za;
      if (k != 0 && k2 != k) s[pk2] = zb;
    }
    dit_stages(s, H, H, n, tw);
    if (half == 0) {
      for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) ework[m] = s[m];
    }
  }
}

// Global branch, output: z'[m] = E[m] + W_M^-m O[m] for m < L/2.
template <class Emit>
__device__ void emit_global(const float2* s, const float2* ework, int L, const float2* tw, Emit emit) {
  for (int m = threadIdx.x; 2 * m < L; m += blockDim.x) {
    const float2 zz = cadd(ework[m], cmul(s[m], cconj(__ldg(&tw[2 * m]))));
    emit(2 * m, zz.x);
    if (2 * m + 1 < L) emit(2 * m + 1, zz.y);
  }
}

// Threads a block runs at this width: half the complex elements the shared
// buffer holds, between 32 and kMaxThreads.
inline int block_threads(int log2n) {
  const int elems = shared_branch(log2n) ? (1 << (log2n - 1)) : (1 << (log2n - 2));
  int threads = elems >> 1;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  return threads;
}

// Bytes of the FFT buffer in shared memory.
inline size_t fft_smem_bytes(int log2n) {
  const int elems = shared_branch(log2n) ? (1 << (log2n - 1)) : (1 << (log2n - 2));
  return (size_t)elems * sizeof(float2);
}

// Launch kernel<<<rows, threads, smem>>>(a) after raising its dynamic shared
// memory limit; returns the launch's cudaError_t.
template <typename A>
cudaError_t launch(void (*kernel)(A), const A& a, int rows, int threads, size_t smem, cudaStream_t stream) {
  if (smem > (size_t)kMaxSmemBytes || rows <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fftconv
