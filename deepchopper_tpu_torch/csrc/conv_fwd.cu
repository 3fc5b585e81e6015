// Causal FFT long conv, forward: y = causal_conv(v, k) + v * bias, ungated.
//
// Replaces the Pallas TPU kernel `_conv_kernel` (deepchopper_tpu/ops/pallas_fft.py),
// entered there through `fft_causal_conv_pallas`. Same contract, channel-last:
//
//   v     (B, L, D)  float32
//   khat  (D, M + 1) complex64 filter spectrum at N = 2M with 1/N and the skip
//                    bias folded in (made by the wrapper, as for mixer_fwd.cu)
//   tw    (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   y     (B, L, D)  float32
//
// The JAX driver moves the channel axis in front outside its kernel; this one
// reads and writes the channel-last layout in place, at a stride of D elements,
// so no transpose pass runs. One block per (batch row, channel), batch-row-major:
// the blocks of neighbouring channels run together and share each 32-byte
// sector of v and y through L2. Algorithm and branches: mixer_fwd.cu's
// (fftconv.cuh); the global branch (N = 65536) reads v twice.
//
// What bounds it on an H100. Bytes: one read and one write of a (B, L, D) float32
// stream, 8 B per token-channel; operations: ~5 N log2 N f32 flops per row. The
// strided accesses use 4 of every 32 bytes a sector moves unless the neighbouring
// channels' blocks find it in L2, and the radix-2 stages (one barrier each) keep
// the kernel well above both bounds.

#include <stdint.h>

#include "fftconv.cuh"

namespace {

using namespace mixer_common;

struct Args {
  const float* v;
  const float2* khat;
  const float2* tw;
  float2* scratch;
  float* y;
  int D;
  int L;
  int log2n;
};

struct Rows {
  const float* v;
  float* y;
  int D;
  int L;

  __device__ Rows(const Args& a) {
    const int b = blockIdx.x / a.D;
    const int c = blockIdx.x % a.D;
    const size_t base = (size_t)b * a.L * a.D + c;
    v = a.v + base;
    y = a.y + base;
    D = a.D;
    L = a.L;
  }
  __device__ float w(int n) const { return n < L ? v[(size_t)n * D] : 0.f; }
  __device__ float2 pair(int m) const { return make_float2(w(2 * m), w(2 * m + 1)); }
  __device__ void emit(int n, float out) const { y[(size_t)n * D] = out; }
};

__global__ void conv_fwd_shared(Args a) {
  extern __shared__ float2 s[];
  const Rows r(a);
  const float2* kh = a.khat + (size_t)(blockIdx.x % a.D) * ((1 << (a.log2n - 1)) + 1);
  fftconv::fill_shared(s, a.log2n, a.tw, [&](int m) { return r.pair(m); });
  fftconv::core_shared(s, a.log2n, kh, a.tw);
  fftconv::emit_shared(s, a.log2n, a.L, a.tw, [&](int n, float out) { r.emit(n, out); });
}

__global__ void conv_fwd_global(Args a) {
  extern __shared__ float2 s[];
  const Rows r(a);
  const float2* kh = a.khat + (size_t)(blockIdx.x % a.D) * ((1 << (a.log2n - 1)) + 1);
  float2* ework = a.scratch + (size_t)blockIdx.x * (1 << (a.log2n - 2));
  fftconv::core_global(s, ework, a.log2n, a.L, kh, a.tw, [&](int m) { return r.pair(m); });
  fftconv::emit_global(s, ework, a.L, a.tw, [&](int n, float out) { r.emit(n, out); });
}

}  // namespace

extern "C" {

// Bytes of global scratch the call needs (0 on the shared-memory branch).
long long conv_fwd_scratch_bytes(int B, int D, int log2n) {
  if (fftconv::shared_branch(log2n)) return 0;
  return (long long)B * D * (1ll << (log2n - 2)) * (long long)sizeof(float2);
}

// Returns the cudaError_t of the launch.
int conv_fwd(const float* v, const void* khat, const void* tw, void* scratch, float* y, int B, int D, int L,
             int log2n, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > 16 || (1 << log2n) < 2 * L) return (int)cudaErrorInvalidValue;
  Args a{v, static_cast<const float2*>(khat), static_cast<const float2*>(tw), static_cast<float2*>(scratch), y, D, L,
         log2n};
  auto kernel = fftconv::shared_branch(log2n) ? conv_fwd_shared : conv_fwd_global;
  return (int)fftconv::launch(kernel, a, B * D, fftconv::block_threads(log2n), fftconv::fft_smem_bytes(log2n),
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
