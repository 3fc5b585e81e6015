// Gated causal FFT conv, forward: gate -> causal FFT long conv -> gate, on gates
// whose short conv is already done.
//
// Replaces two Pallas TPU kernels of deepchopper_tpu/ops/pallas_fft.py, entered
// there through `gated_fft_conv_cm`: `_gated_kernel` and its block-layout twin
// `_gated_kernel_v2` (DEEPCHOPPER_FFT_LAYOUT=v2). Both compute the same function;
// they differ only in how a TPU tiles it. Same contract, batch-major:
//
//   uc    (B, 3D, L) [x2 | x1 | v], already short-convolved, float32 or bfloat16
//   khat  (D, M + 1) complex64 filter spectrum at N = 2M with 1/N and the skip
//                    bias folded in (made by the wrapper, as for mixer_fwd.cu)
//   tw    (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   out   (B, D, L)  uc's dtype: out = (causal_conv(w, k) + w * bias) * x2,
//                    w = f32(v) * f32(x1) (each gate widened first, then the
//                    product formed in float32; the Pallas kernels round the
//                    product to the input dtype first, which bfloat16 I/O shows).
//
// Algorithm and branches: mixer_fwd.cu's (fftconv.cuh), one block per (batch
// row, channel) in batch-row-major order; the fill reads x1 and v directly where
// mixer_fwd.cu short-convolves them. The global branch (N = 65536) reads x1 and v
// twice, once per half (from L2 in practice).
//
// What bounds it on an H100: as mixer_fwd.cu. Bytes: three reads and one write of a
// (B, D, L) stream; operations: ~5 N log2 N f32 flops per row on the CUDA cores.
// The radix-2 stages in shared memory, one barrier each, keep it well above both.

#include <stdint.h>

#include "fftconv.cuh"

namespace {

using namespace mixer_common;

struct Args {
  const void* uc;
  const float2* khat;
  const float2* tw;
  float2* scratch;
  void* out;
  int D;
  int L;
  int log2n;
};

template <typename T>
struct Rows {
  const T* x2;
  const T* x1;
  const T* v;
  T* out;
  int L;

  __device__ Rows(const Args& a) {
    const int b = blockIdx.x / a.D;
    const int c = blockIdx.x % a.D;
    const T* uc = static_cast<const T*>(a.uc) + (size_t)b * 3 * a.D * a.L;
    x2 = uc + (size_t)c * a.L;
    x1 = uc + (size_t)(a.D + c) * a.L;
    v = uc + (size_t)(2 * a.D + c) * a.L;
    out = static_cast<T*>(a.out) + ((size_t)b * a.D + c) * a.L;
    L = a.L;
  }
  __device__ float w(int n) const { return n < L ? to_f(v[n]) * to_f(x1[n]) : 0.f; }
  __device__ float2 pair(int m) const { return make_float2(w(2 * m), w(2 * m + 1)); }
  __device__ void emit(int n, float y) const { store(&out[n], y * to_f(x2[n])); }
};

template <typename T>
__global__ void gated_fwd_shared(Args a) {
  extern __shared__ float2 s[];
  const Rows<T> r(a);
  const float2* kh = a.khat + (size_t)(blockIdx.x % a.D) * ((1 << (a.log2n - 1)) + 1);
  fftconv::fill_shared(s, a.log2n, a.tw, [&](int m) { return r.pair(m); });
  fftconv::core_shared(s, a.log2n, kh, a.tw);
  fftconv::emit_shared(s, a.log2n, a.L, a.tw, [&](int n, float y) { r.emit(n, y); });
}

template <typename T>
__global__ void gated_fwd_global(Args a) {
  extern __shared__ float2 s[];
  const Rows<T> r(a);
  const float2* kh = a.khat + (size_t)(blockIdx.x % a.D) * ((1 << (a.log2n - 1)) + 1);
  float2* ework = a.scratch + (size_t)blockIdx.x * (1 << (a.log2n - 2));
  fftconv::core_global(s, ework, a.log2n, a.L, kh, a.tw, [&](int m) { return r.pair(m); });
  fftconv::emit_global(s, ework, a.L, a.tw, [&](int n, float y) { r.emit(n, y); });
}

template <typename T>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream) {
  auto kernel = fftconv::shared_branch(a.log2n) ? gated_fwd_shared<T> : gated_fwd_global<T>;
  return fftconv::launch(kernel, a, rows, fftconv::block_threads(a.log2n), fftconv::fft_smem_bytes(a.log2n), stream);
}

}  // namespace

extern "C" {

// Bytes of global scratch the call needs (0 on the shared-memory branch).
long long gated_fwd_scratch_bytes(int B, int D, int log2n) {
  if (fftconv::shared_branch(log2n)) return 0;
  return (long long)B * D * (1ll << (log2n - 2)) * (long long)sizeof(float2);
}

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int gated_fwd(const void* uc, const void* khat, const void* tw, void* scratch, void* out, int B, int D, int L,
              int log2n, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > 16 || (1 << log2n) < 2 * L) return (int)cudaErrorInvalidValue;
  Args a{uc, static_cast<const float2*>(khat), static_cast<const float2*>(tw), static_cast<float2*>(scratch), out,
         D, L, log2n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, B * D, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B * D, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
