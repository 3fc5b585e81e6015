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
// reads and writes the channel-last layout in place, so no transpose pass
// runs. The transforms are mixer_fwd.cu's: the half-length trick, two
// `fft_radix.cuh` transforms of H = N/4 a row (half 0 = z, half 1 = z W_M^m),
// the pair pass on the spectrum in natural order, the two inverses, and the
// last stage z'[m] = E[m] + W_M^-m O[m] straight into y.
//
// Two kernels, on the plan of `ops/conv.conv_fwd_plan` (modelled in
// tests/test_torch_port_conv_plan.py):
//   * rows: N <= 32768. A block takes G neighbouring channels of one batch
//     row, both halves of each in shared memory ([G][2][padded(H)] float2,
//     then the quarter table), and runs its 2G transforms at once, H / V
//     threads each. G is what gives 256 threads a block, but at least 2 and
//     at most 8, and no more than 227 KB holds (1 at N = 32768) or D needs:
//     8 up to N = 1024, 4 at 2048, 2 from 4096 to 16384. A thread of the
//     fill takes two neighbouring positions of CW = min(G, 4) neighbouring
//     channels, as two vector loads of CW floats (16 bytes at G >= 4), and
//     scatters the pair into the CW rows' transforms; the output gathers
//     them back the same way. At G = 8 the two threads of a position read
//     its 32-byte sector whole. Blocks run channel group fastest, so at
//     G < 8 the blocks that share a sector run together and meet in L2.
//     Measured on an H100 (PERF.md), blocks of 256 threads, several an SM,
//     beat the widest tile the shared memory holds (G = 8 up to N = 4096, 4
//     at 8192: one block of 1024 threads an SM) by 3-10% a width: the
//     barriers of one large block cost more than the partly used sectors.
//   * pair: N = 65536 (L = 24576, 32768). One channel of one batch row is a
//     cluster of two CTAs, CTA r holding half r, as in mixer_fwd.cu. Each CTA
//     reads half of the row's positions and writes z into CTA 0's half and
//     z W_M^m into CTA 1's, through distributed shared memory, so v is read
//     once; they meet again for the last stage. No global scratch.
// D not a multiple of G leaves the last group's tail channels idle; D not a
// multiple of CW, or a row off CW-float alignment, takes scalar loads.
//
// What bounds it on an H100. Bytes: one read and one write of a (B, L, D)
// float32 stream, 8 B per token-channel, plus the khat rows; operations:
// ~5 N log2 N f32 flops a row, as mixer_fwd.cu. The first design (radix-2
// stages in shared memory, one channel a block, a global scratch row at
// N = 65536) ran at ~32x the bound; this one runs mixer_fwd.cu's transforms,
// and what the strided layout costs at G <= 2 is measured in PERF.md.

#include <stdint.h>

#include <cooperative_groups.h>

#include "fft_radix.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mixer_common;
using fft_radix::pad;
using fft_radix::padded;
using fft_radix::quarter;

constexpr int kPairLog2h = 14;  // N = 65536: one half fills a CTA's shared memory
constexpr int kPairThreads = 512;
constexpr int kMaxG = 8;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

struct Args {
  const float* v;
  const float2* khat;
  const float2* tw;
  float* y;
  int D;
  int L;
  int log2n;
  int G;     // channels a block (rows)
  bool vec;  // v and y rows of CW floats start on CW * 4 bytes
};

// x[j] = v at position n, channel c + j (j < CW), zero past L or D.
template <int CW>
__device__ __forceinline__ void load_cw(const float* p, int n, int c, const Args& a, float* x) {
  if (a.vec && n < a.L && c + CW <= a.D) {
    if constexpr (CW == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
    } else if constexpr (CW == 2) {
      const float2 u = __ldg(reinterpret_cast<const float2*>(p));
      x[0] = u.x, x[1] = u.y;
    } else {
      x[0] = __ldg(p);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) x[j] = n < a.L && c + j < a.D ? __ldg(p + j) : 0.f;
  }
}

// y at position n (< L), channels c + j < D, from x[j].
template <int CW>
__device__ __forceinline__ void store_cw(float* p, int c, const Args& a, const float* x) {
  if (a.vec && c + CW <= a.D) {
    if constexpr (CW == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else if constexpr (CW == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else {
      *p = x[0];
    }
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (c + j < a.D) p[j] = x[j];
  }
}

// Rows fill: for m < H and each channel g of the block, z[m] = v[2m] + i
// v[2m+1] into half 0 of row g and z W_M^m into half 1. Item i is (m, channel
// vector q), q fastest: a warp's loads cover whole positions' channels.
template <int CW>
__device__ __forceinline__ void fill_rows(const Args& a, const float* vb, int c0, int H, int hp, float2* s) {
  const int nq = a.G / CW;
  for (int i = threadIdx.x; i < H * nq; i += blockDim.x) {
    const int m = i / nq, g = (i - m * nq) * CW;
    float x0[CW], x1[CW];
    load_cw<CW>(vb + (size_t)(2 * m) * a.D + g, 2 * m, c0 + g, a, x0);
    load_cw<CW>(vb + (size_t)(2 * m + 1) * a.D + g, 2 * m + 1, c0 + g, a, x1);
    const float2 w = __ldg(&a.tw[2 * m]);
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      float2* row = s + (size_t)(g + j) * 2 * hp;
      const float2 z = make_float2(x0[j], x1[j]);
      row[pad(m)] = z;
      row[hp + pad(m)] = cmul(z, w);
    }
  }
}

// Rows output: z'[m] = E[m] + conj(W_M^m) O[m] for 2m < L, each channel's
// pair of positions gathered into two vector stores of CW floats.
template <int CW>
__device__ __forceinline__ void emit_rows(const Args& a, float* yb, int c0, int hp, const float2* s) {
  const int nq = a.G / CW;
  const int half = (a.L + 1) / 2;
  for (int i = threadIdx.x; i < half * nq; i += blockDim.x) {
    const int m = i / nq, g = (i - m * nq) * CW;
    const float2 w = cconj(__ldg(&a.tw[2 * m]));
    float y0[CW], y1[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const float2* row = s + (size_t)(g + j) * 2 * hp;
      const float2 zz = cadd(row[pad(m)], cmul(row[hp + pad(m)], w));
      y0[j] = zz.x;
      y1[j] = zz.y;
    }
    store_cw<CW>(yb + (size_t)(2 * m) * a.D + g, c0 + g, a, y0);
    if (2 * m + 1 < a.L) store_cw<CW>(yb + (size_t)(2 * m + 1) * a.D + g, c0 + g, a, y1);
  }
}

// N <= 32768: G channels of batch row b per block (see the header), 2G H / V
// threads. Below V = 32 built for two blocks of 512 an SM (64 registers,
// as mixer_fwd.cu's rows kernel), else for one.
template <int V>
__global__ void __launch_bounds__(512, V >= 32 ? 1 : 2) conv_fwd_rows(Args a) {
  extern __shared__ float2 s[];
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  const int G = a.G;
  const int nt = H / V;  // threads of one transform
  const int hp = padded(H);
  float2* wt = s + (size_t)G * 2 * hp;
  const int ng = (a.D + G - 1) / G;
  const int b = blockIdx.x / ng;
  const int c0 = (blockIdx.x - b * ng) * G;
  const size_t base = (size_t)b * a.L * a.D + c0;
  fft_radix::stage_quarter_table(wt, a.tw, H);
  switch (G) {
    case 1: fill_rows<1>(a, a.v + base, c0, H, hp, s); break;
    case 2: fill_rows<2>(a, a.v + base, c0, H, hp, s); break;
    default: fill_rows<4>(a, a.v + base, c0, H, hp, s); break;
  }
  __syncthreads();

  // Transform tr = 2g + half of the block. Every plan runs the 2G at once
  // (blockDim.x = 2G nt), but as a loop over blockDim.x / nt at a time: so
  // written, ptxas reports no spills at V = 32 where the straight form
  // spills 360 B, and the straight form measured 5-15% slower from N =
  // 16384 on an H100 (PERF.md).
  const int at_once = blockDim.x / nt;
  for (int t0 = 0; t0 < 2 * G; t0 += at_once) {
    const int tr = t0 + threadIdx.x / nt;
    fft_radix::fft<V, false>(s + (size_t)tr * hp, log2h, threadIdx.x % nt, c0 + (tr >> 1) < a.D, wt);
  }
  // Pairs (k, M - k) for k in [0, H) per channel; k = 0 also takes bin H.
  for (int i = threadIdx.x; i < G << log2h; i += blockDim.x) {
    const int g = i >> log2h, k = i & (H - 1);
    if (c0 + g >= a.D) continue;
    float2* row = s + (size_t)g * 2 * hp;
    const float2* kh = a.khat + (size_t)(c0 + g) * (M + 1);
    fft_radix::spectral_pair(row, hp, k, M, kh, a.tw);
    if (k == 0) fft_radix::spectral_pair(row, hp, H, M, kh, a.tw);
  }
  __syncthreads();
  for (int t0 = 0; t0 < 2 * G; t0 += at_once) {
    const int tr = t0 + threadIdx.x / nt;
    fft_radix::fft<V, true>(s + (size_t)tr * hp, log2h, threadIdx.x % nt, c0 + (tr >> 1) < a.D, wt);
  }

  switch (G) {
    case 1: emit_rows<1>(a, a.y + base, c0, hp, s); break;
    case 2: emit_rows<2>(a, a.y + base, c0, hp, s); break;
    default: emit_rows<4>(a, a.y + base, c0, hp, s); break;
  }
}

// N = 65536: channel c of batch row b per cluster of two CTAs, CTA `rank`
// holding half `rank`: [padded(H)] float2, then the quarter table.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kPairThreads, 1) conv_fwd_pair(Args a) {
  extern __shared__ float2 s[];
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
  const int c = (blockIdx.x >> 1) - b * D;
  const size_t base = (size_t)b * L * D + c;
  fft_radix::stage_quarter_table(wt, a.tw, H);

  // CTA r fills m in [r H/2, (r + 1) H/2) of both halves: v is read once.
  cluster.sync();  // the other CTA has started: its shared memory takes writes
  float2* h0 = cluster.map_shared_rank(s, 0);
  float2* h1 = cluster.map_shared_rank(s, 1);
  for (int i = threadIdx.x; i < H / 2; i += blockDim.x) {
    const int m = rank * (H / 2) + i;
    const float2 z = make_float2(2 * m < L ? __ldg(&a.v[base + (size_t)(2 * m) * D]) : 0.f,
                                 2 * m + 1 < L ? __ldg(&a.v[base + (size_t)(2 * m + 1) * D]) : 0.f);
    h0[pad(m)] = z;
    h1[pad(m)] = cmul(z, __ldg(&a.tw[2 * m]));
  }
  cluster.sync();  // both halves filled
  fft_radix::fft<V, false>(s, log2h, threadIdx.x, true, wt);
  fft_radix::half_pairs(s, rank, H, a.khat + (size_t)c * (M + 1), a.tw);
  __syncthreads();
  fft_radix::fft<V, true>(s, log2h, threadIdx.x, true, wt);

  // Both halves done: each CTA writes half of the outputs, reading the
  // other's half through distributed shared memory.
  cluster.sync();
  const float2* other = cluster.map_shared_rank(s, rank ^ 1);
  const float2* e = rank ? other : s;
  const float2* o = rank ? s : other;
  const int half = (L + 1) / 2;
  const int per = (half + 1) / 2;
  const int mend = min(half, (rank + 1) * per);
  for (int m = rank * per + threadIdx.x; m < mend; m += blockDim.x) {
    const float2 zz = cadd(e[pad(m)], cmul(o[pad(m)], cconj(__ldg(&a.tw[2 * m]))));
    a.y[base + (size_t)(2 * m) * D] = zz.x;
    if (2 * m + 1 < L) a.y[base + (size_t)(2 * m + 1) * D] = zz.y;
  }
  cluster.sync();  // keep this CTA's half alive until the other has read it
}

template <int V>
cudaError_t launch_rows(const Args& a, int B, size_t smem, cudaStream_t stream) {
  const int threads = 2 * a.G * ((1 << (a.log2n - 2)) / V);
  cudaError_t err = cudaFuncSetAttribute(conv_fwd_rows<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv_fwd_rows<V><<<B * ((a.D + a.G - 1) / a.G), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// G from `ops/conv.conv_fwd_plan` (1 at N = 65536). Returns the cudaError_t
// of the launch; cudaErrorInvalidValue for a plan the kernels do not take.
int conv_fwd(const float* v, const void* khat, const void* tw, float* y, int B, int D, int L, int log2n, int G,
             void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > kPairLog2h + 2 || (1 << log2n) < 2 * L || G < 1 ||
      G > kMaxG || (G & (G - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int CW = G < 4 ? G : 4;
  const bool vec = D % CW == 0 && ((uintptr_t)v & (CW * 4 - 1)) == 0 && ((uintptr_t)y & (CW * 4 - 1)) == 0;
  const Args a{v, static_cast<const float2*>(khat), static_cast<const float2*>(tw), y, D, L, log2n, G, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int log2h = log2n - 2;
  const int H = 1 << log2h;
  if (log2h == kPairLog2h) {
    if (G != 1) return (int)cudaErrorInvalidValue;
    const size_t smem = ((size_t)padded(H) + quarter(H)) * sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(conv_fwd_pair, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    conv_fwd_pair<<<2 * B * D, kPairThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const int V = fft_radix::values_per_thread(H);
  const size_t smem = ((size_t)G * 2 * padded(H) + quarter(H)) * sizeof(float2);
  if (2 * G * (H / V) > mixer_common::kMaxThreads || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  switch (V) {
    case 2: return (int)launch_rows<2>(a, B, smem, st);
    case 4: return (int)launch_rows<4>(a, B, smem, st);
    case 8: return (int)launch_rows<8>(a, B, smem, st);
    case 16: return (int)launch_rows<16>(a, B, smem, st);
    default: return (int)launch_rows<32>(a, B, smem, st);
  }
}

}  // extern "C"
