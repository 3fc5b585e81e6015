// in_proj-fused Hyena mixer, forward: in_proj GEMM -> short conv -> gate ->
// causal FFT long conv -> gate, in one kernel.
//
// Replaces the Pallas TPU kernel `_mixer_inproj_kernel`
// (deepchopper_tpu/ops/pallas_fft.py), entered there through
// `mixer_fft_conv_inproj`. Same contract, batch-major:
//
//   x     (B, D, L)  the normalized stream, float32 or bfloat16
//   w     (3D, D)    in_proj weight in x's dtype, row j = output channel j
//                    (torch's Linear layout: the transpose of the flax kernel)
//   b_in  (3D,)      float32 in_proj bias
//   taps  (3, 3D)    float32 short-conv taps, tap t multiplies p[n - (2 - t)]
//   bsh   (3D,)      float32 short-conv bias
//   khat  (D, M + 1) complex64 filter spectrum (1/N and the skip bias folded in)
//   tw    (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   out   (B, D, L)  x's dtype: mixer_fwd.cu's function of proj = w x + b_in,
//                    with proj held in float32 (products of x and w, each
//                    widened from its dtype, summed over D in float32; the
//                    bias added unrounded), never rounded to x's dtype.
//
// One block per (batch row, channel c), batch-row-major, so the blocks that
// run together read the same x[b] (D x L) and find it in L2. A block computes
// only its own three projected rows (x2, x1, v of channel c): the GEMM's
// 2 * 3D * D flops a token are done once over the grid, on the CUDA cores, an
// f32 fused multiply-add loop over D with the block's three weight rows in
// shared memory. The sequence runs in chunks of 2 x threads positions, two
// per thread; the three projected values of each position go to a small
// shared window that keeps the previous chunk's last two positions, so the
// 3-tap short conv needs no recompute. Per chunk the block then forms the
// gates, w = v * x1 and the x2 gate.
//   * shared branch (N <= 32768, L <= 16384): w goes straight into the FFT
//     buffer (first DIF stage folded in) and the x2 gate into a shared row
//     of L floats: nothing but x and the output touches device memory.
//   * global branch (N = 65536, L = 24576 and 32768): the FFT buffer holds only
//     one half, so w (as z pairs) and the x2 gate are parked in the block's
//     own global scratch rows, beside the half-0 inverse E, as mixer_fwd.cu
//     parks E. The (B, 3D, L) projection is never written as such.
// The long conv then runs as in mixer_fwd.cu (fftconv.cuh).
//
// What bounds it on an H100. Bytes: x read and out written once (4 B a
// token-channel in bfloat16) plus the weight. Operations: the GEMM's 6 D^2 =
// 393,216 flops a token, ~75x the FFT's; at the bf16 tensor-core peak (989
// TFLOP/s) that is about 0.05 ms per 2^17 tokens, on the CUDA cores in f32 (67
// TFLOP/s) ~0.8 ms. This first design issues two global loads and three shared
// loads for every six FMAs and reads x[b] once per channel (from L2), so it is
// bound by load issue, well above either figure; wgmma tiles over (channel
// group x positions) are the known way to close it.

#include <stdint.h>

#include "fftconv.cuh"

namespace {

using namespace mixer_common;

struct Args {
  const void* x;
  const void* w;
  const float* b_in;
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

// Floats of shared memory beside the FFT buffer: three weight rows, the three
// projected windows, and (shared branch) the x2 gate row.
__host__ __device__ inline int extra_floats(int D, int L, int threads, bool shared) {
  return 3 * D + 3 * (2 * threads + 2) + (shared ? L : 0);
}

template <typename T, bool kShared>
__global__ void inproj_fwd(Args a) {
  extern __shared__ float2 smem[];
  const int D = a.D;
  const int L = a.L;
  const int H = 1 << (a.log2n - 2);
  const int b = blockIdx.x / D;
  const int c = blockIdx.x % D;
  const int tid = threadIdx.x;
  const int P = 2 * blockDim.x;  // positions a chunk
  const int stride = P + 2;      // window: positions n0 - 2 .. n0 + P - 1

  float2* s = smem;
  float* wrow = reinterpret_cast<float*>(smem + (kShared ? 2 * H : H));
  float* win = wrow + 3 * D;
  float2* zrow = a.scratch + (size_t)blockIdx.x * 3 * H;  // global branch only
  float2* ework = zrow + H;
  float* g2row = kShared ? win + 3 * stride : reinterpret_cast<float*>(ework + H);

  const T* wt = static_cast<const T*>(a.w);
  for (int i = tid; i < 3 * D; i += blockDim.x) {
    const int g = i / D;
    wrow[i] = to_f(wt[(size_t)(g * D + c) * D + (i - g * D)]);
  }
  if (tid < 6) win[(tid >> 1) * stride + (tid & 1)] = 0.f;  // p[-2] = p[-1] = 0
  const Gate gx2(a.taps, a.bsh, D, c), gx1(a.taps, a.bsh, D, D + c), gv(a.taps, a.bsh, D, 2 * D + c);
  const float bin[3] = {a.b_in[c], a.b_in[D + c], a.b_in[2 * D + c]};
  __syncthreads();

  const T* xb = static_cast<const T*>(a.x) + (size_t)b * D * L;
  for (int n0 = 0; n0 < L; n0 += P) {
    const int n = n0 + 2 * tid;
    float acc[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (n < L) {
      const bool two = n + 1 < L;
      const T* xp = xb + n;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float x0 = to_f(xp[(size_t)d * L]);
        const float x1 = two ? to_f(xp[(size_t)d * L + 1]) : 0.f;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float wv = wrow[g * D + d];
          acc[g][0] = fmaf(wv, x0, acc[g][0]);
          acc[g][1] = fmaf(wv, x1, acc[g][1]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      win[g * stride + 2 + 2 * tid] = acc[g][0] + bin[g];
      win[g * stride + 3 + 2 * tid] = acc[g][1] + bin[g];
    }
    __syncthreads();
    if (n < L) {
      float wpair[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 2 + 2 * tid + j;  // window index of position n + j
        const float* p2 = win + i;
        const float* p1 = win + stride + i;
        const float* pv = win + 2 * stride + i;
        // Same expression as mixer_common's gate(): k0 p[n-2] + k1 p[n-1] + k2 p[n] + b.
        const float x2g = gx2.k0 * p2[-2] + gx2.k1 * p2[-1] + gx2.k2 * p2[0] + gx2.b;
        const float x1g = gx1.k0 * p1[-2] + gx1.k1 * p1[-1] + gx1.k2 * p1[0] + gx1.b;
        const float vg = gv.k0 * pv[-2] + gv.k1 * pv[-1] + gv.k2 * pv[0] + gv.b;
        if (n + j < L) {
          g2row[n + j] = x2g;
          wpair[j] = vg * x1g;
        } else {
          wpair[j] = 0.f;
        }
      }
      const int m = n >> 1;
      const float2 z = make_float2(wpair[0], wpair[1]);
      if (kShared) {
        s[m] = z;
        s[m + H] = cmul(z, __ldg(&a.tw[2 * m]));
      } else {
        zrow[m] = z;
      }
    }
    __syncthreads();
    if (tid < 6) {
      const int g = tid >> 1;
      win[g * stride + (tid & 1)] = win[g * stride + P + (tid & 1)];
    }
    __syncthreads();
  }

  const int live = (L + 1) >> 1;  // z[m] is zero from here on
  const float2* kh = a.khat + (size_t)c * (2 * H + 1);
  T* out = static_cast<T*>(a.out) + ((size_t)b * D + c) * L;
  auto emit = [&](int nn, float y) { store(&out[nn], y * g2row[nn]); };
  if (kShared) {
    for (int m = live + tid; m < H; m += blockDim.x) {
      s[m] = make_float2(0.f, 0.f);
      s[m + H] = make_float2(0.f, 0.f);
    }
    fftconv::core_shared(s, a.log2n, kh, a.tw);
    fftconv::emit_shared(s, a.log2n, L, a.tw, emit);
  } else {
    fftconv::core_global(s, ework, a.log2n, L, kh, a.tw,
                         [&](int m) { return m < live ? zrow[m] : make_float2(0.f, 0.f); });
    fftconv::emit_global(s, ework, L, a.tw, emit);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int rows, cudaStream_t stream) {
  const bool shared = fftconv::shared_branch(a.log2n);
  const int threads = fftconv::block_threads(a.log2n);
  const size_t smem = fftconv::fft_smem_bytes(a.log2n) + sizeof(float) * extra_floats(a.D, a.L, threads, shared);
  auto kernel = shared ? inproj_fwd<T, true> : inproj_fwd<T, false>;
  return fftconv::launch(kernel, a, rows, threads, smem, stream);
}

}  // namespace

extern "C" {

// Bytes of global scratch the call needs: on the global branch three rows of
// H complex per block (z pairs, E, the x2 gate); 0 on the shared branch.
long long mixer_inproj_fwd_scratch_bytes(int B, int D, int log2n) {
  if (fftconv::shared_branch(log2n)) return 0;
  return (long long)B * D * 3 * (1ll << (log2n - 2)) * (long long)sizeof(float2);
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape the kernel does not take,
// such as a D whose weight rows outgrow shared memory).
int mixer_inproj_fwd(const void* x, const void* w, const float* b_in, const float* taps, const float* bsh,
                     const void* khat, const void* tw, void* scratch, void* out, int B, int D, int L, int log2n,
                     int dtype, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > 16 || (1 << log2n) < 2 * L) return (int)cudaErrorInvalidValue;
  Args a{x, w, b_in, taps, bsh, static_cast<const float2*>(khat), static_cast<const float2*>(tw),
         static_cast<float2*>(scratch), out, D, L, log2n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, B * D, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, B * D, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
