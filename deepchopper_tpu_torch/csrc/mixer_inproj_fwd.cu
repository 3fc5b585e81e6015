// in_proj-fused Hyena mixer, forward: in_proj GEMM -> short conv -> gate ->
// causal FFT long conv -> gate, in one kernel.
//
// Replaces the Pallas TPU kernel `_mixer_inproj_kernel`
// (deepchopper_tpu/ops/pallas_fft.py), entered there through
// `mixer_fft_conv_inproj`. Same contract, batch-major:
//
//   x       (B, D, L)  the normalized stream, float32 or bfloat16
//   w       (3D, D)    in_proj weight in x's dtype, row j = output channel j
//                      (torch's Linear layout: the transpose of the flax kernel)
//   b_in    (3D,)      float32 in_proj bias
//   taps    (3, 3D)    float32 short-conv taps, tap t multiplies p[n - (2 - t)]
//   bsh     (3D,)      float32 short-conv bias
//   khat    (D, M + 1) complex64 filter spectrum (1/N and the skip bias folded in)
//   tw      (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   scratch            float32, mixer_inproj_fwd_scratch_bytes(B, D, L, log2n)
//   out     (B, D, L)  x's dtype: mixer_fwd.cu's function of proj = w x + b_in,
//                      with proj held in float32 (products of x and w, each
//                      widened from its dtype, summed over D in float32; the
//                      bias added unrounded), never rounded to x's dtype.
//
// The TPU kernel keeps x[b] resident in VMEM across an inner grid of channel
// groups and makes each group's projected rows on the MXU. Here a block (from
// N = 32768 on a cluster of two CTAs) takes one batch row b and a group of CG
// channels (16, or 8 from N = 32768 on; ceil(D / CG) groups, the last one part
// empty) in two phases:
//   1. Projection. The group's 3 CG weight rows are staged in shared memory
//      once, K = D padded with zeros to a multiple of 16. x[b] streams through
//      in tiles of TP positions (64 in bfloat16, 32 in float32) by cp.async,
//      double buffered (the weights come in the first tile's group); each
//      tile is a (TP x 3CG) product on the tensor cores, `mma.sync.m16n8k16`
//      bf16 x bf16 -> f32, one warp a 16-position m-tile and up to three n8
//      tiles of projected rows, four k-steps an iteration into sums of their
//      own. bfloat16 x is exact in bf16; float32 x and w are each split into
//      three bf16 terms (hi + mid + lo, 24 bits), and the six products down
//      to 2^-16 of the largest are summed, the five small ones in an
//      accumulator of their own. The tile plus b_in goes to a shared (3CG x
//      (2 + TP)) float32 window whose first two columns carry the previous
//      tile's last two positions, so the 3-tap short conv runs across tile
//      edges without recompute; the gates then give z[m] = w[2m] + i w[2m+1]
//      (w = v x1, zero at n >= L) and the x2 gate, both float32, stored to the
//      block's scratch rows with streaming stores (evicted first, so x's
//      tiles keep their place in L2). Two barriers a tile: the carried
//      positions alternate between two small arrays.
//   2. Long conv, per channel of the group, as mixer_fwd.cu runs it on
//      fft_radix.cuh: the half-length real trick, two length-H halves of 2-4
//      register passes each, the pair pass, the inverse halves and the last
//      stage, whose z' times the x2 gate is the output. Up to N = 16384 a block
//      of 256 threads runs G = min(CG, 256 / (2 H / V)) channels at a time in
//      shared memory; from N = 32768 on a cluster of two CTAs of H / 32
//      threads takes the group, CTA r holding half r (each CTA projected one
//      half of the positions, the second from one tile early for the carry),
//      and the halves meet through distributed shared memory, as mixer_fwd's
//      pair kernel. Phase 1's buffers and phase 2's rows share the memory, and
//      two blocks fit an SM up to N = 32768, so one's projection runs beside
//      another's transforms.
// So x[b] is read from L2 D / CG times (not D times), and the (B, 3D, L)
// projection never exists in device memory: only z and the x2 gate, 8 bytes a
// token-channel, go through scratch, which stays in L2 where a group's rows
// are small (phase 2 reads them right after phase 1 wrote them). A row's
// arithmetic does not depend on B or on its block's neighbours, and nothing
// is summed by atomics: two calls are bitwise equal.
//
// What bounds it on an H100. Bytes: x read and out written once (4 B a
// token-channel in bfloat16) plus the weight. Operations: the GEMM's 6 D^2
// flops a token at the bf16 tensor-core peak (989 TFLOP/s), 0.05 ms per 2^17
// tokens at D = 256, plus the FFT's float32 flops (0.1 ms). In practice the
// long conv costs a little more than mixer_fwd's (shared-memory passes, two
// blocks an SM where mixer_fwd runs four), and phase 1 adds the tile product,
// the cp.async issue and the gates, which share the SM's shared-memory pipe
// with the other block's transforms; x's D / CG reads from L2 (1 GB a
// 2^17-token call at D = 256, CG = 16) and the scratch traffic weigh less.
// At N = 65536 one CTA an SM leaves phase 1 bare. PERF.md has the numbers
// (scripts/torch_inproj_ab.py). The numpy model of this plan is
// tests/test_torch_port_inproj_plan.py.

#include <stdint.h>

#include <algorithm>

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
constexpr int kRowsThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // what a block may use on sm_90
constexpr int kNpw = 3;                // n8 tiles a warp at most

struct Args {
  const void* x;
  const void* w;
  const float* b_in;
  const float* taps;
  const float* bsh;
  const float2* khat;
  const float2* tw;
  float* scratch;
  void* out;
  int B;
  int D;
  int L;
  int log2n;
  int kp;        // D rounded up to 16
  int groups;    // ceil(D / CG)
  int lq;        // L rounded up to 8: a scratch row is z (lq floats), then the x2 gate (lq)
  bool vec_in;   // x rows start on 16 bytes: tiles by cp.async
  bool vec_w;    // the same for the weight rows
  bool vec_out;  // out rows start on 16 bytes and L is a whole number of chunks
};

// Channels a group: a function of the width alone, never of B.
__host__ __device__ constexpr int group_size(int log2n) { return log2n >= 15 ? 8 : 16; }

// Phase 1's tile geometry.
template <typename T, int CG>
struct Tile {
  static constexpr int TP = sizeof(T) == 2 ? 64 : 32;  // positions a tile: 8 chunks of 16 B a row
  static constexpr int E = 16 / (int)sizeof(T);        // elements of a 16-byte chunk
  static constexpr int XS = TP + E;                    // staged x row stride: ldmatrix rows on distinct banks
  static constexpr int PS = TP + 4;                    // window row stride (floats): 2 carried + TP, padded
  static constexpr int R = 3 * CG;                     // projected rows: x2, x1, v of each channel
  static constexpr int NT = R / 8;
  static constexpr int MT = TP / 16;
  // Bytes: two x tiles, the weight rows, the window, b_in, the gates and two carries.
  __host__ __device__ static size_t bytes(int kp) {
    return sizeof(T) * (2 * (size_t)kp * XS + (size_t)R * (kp + E)) + sizeof(float) * ((size_t)R * PS + 9 * R);
  }
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the bytes past `bytes` zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b over one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two float32 values a pair of bf16 fragment halves each of three terms:
// v = hi + mid + lo to 24 bits (each difference is exact in float32).
__device__ __forceinline__ void split_pair(float u, float v, uint32_t* hi, uint32_t* mid, uint32_t* lo) {
  const __nv_bfloat16 uh = __float2bfloat16_rn(u), vh = __float2bfloat16_rn(v);
  const float ur = u - __bfloat162float(uh), vr = v - __bfloat162float(vh);
  const __nv_bfloat16 um = __float2bfloat16_rn(ur), vm = __float2bfloat16_rn(vr);
  *hi = pack(uh, vh);
  *mid = pack(um, vm);
  *lo = pack(__float2bfloat16_rn(ur - __bfloat162float(um)), __float2bfloat16_rn(vr - __bfloat162float(vm)));
}

// One tile's product on the tensor cores: A = x^T (TP positions x kp), B = the
// weight rows^T (kp x 3CG). Warp w takes m-tile w % MT and the n8 tiles w / MT,
// w / MT + nwarps / MT, ...; the result plus b_in goes to the window. bf16 runs
// KU = 4 k-steps an iteration, each into sums of its own, with every fragment
// of the iteration loaded before its first mma: a chain of dependent mmas is
// kp / 64 long, not kp / 16. float32 (the checks' dtype) runs one k-step at a
// time, six products each.
template <typename T, int CG>
__device__ __forceinline__ void tile_product(const T* xs, const T* ws, int kp, float* pt, const float* bin) {
  using S = Tile<T, CG>;
  constexpr int KU = sizeof(T) == 2 ? 4 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nstep = (blockDim.x >> 5) / S::MT;
  const int m0 = (warp % S::MT) * 16, n_first = warp / S::MT;
  const int WS = kp + S::E;
  const int g = lane >> 2, t = lane & 3;
  float acc[KU][kNpw][4] = {}, small[kNpw][4] = {};
  if constexpr (sizeof(T) == 2) {
    // Lane addresses: x4.trans gives A's (k 0-7 | 8-15) x (m 0-7 | 8-15) from
    // the [d][pos] tile; x2 gives B's k 0-7 | 8-15 from the [row][d] weights.
    const T* xa = xs + ((lane & 7) + ((lane >> 4) << 3)) * S::XS + m0 + (((lane >> 3) & 1) << 3);
    const T* wb = ws + (lane & 7) * WS + (((lane >> 3) & 1) << 3);
    auto steps = [&](int k0, int n) {  // n = KU, or 1 for the remainder (into acc[0])
      uint32_t af[KU][4], bf[KU][kNpw][2];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (u >= n) break;
        ldsm_x4_trans(af[u], xa + (k0 + 16 * u) * S::XS);
#pragma unroll
        for (int i = 0; i < kNpw; ++i)
          if (n_first + i * nstep < S::NT) ldsm_x2(bf[u][i], wb + (n_first + i * nstep) * 8 * WS + k0 + 16 * u);
      }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (u >= n) break;
#pragma unroll
        for (int i = 0; i < kNpw; ++i)
          if (n_first + i * nstep < S::NT) mma_bf16(acc[u][i], af[u], bf[u][i]);
      }
    };
    int k0 = 0;
    for (; k0 + 16 * KU <= kp; k0 += 16 * KU) steps(k0, KU);
    for (; k0 < kp; k0 += 16) steps(k0, 1);
  } else {
    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t ah[4], am[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // a[r]: rows g (+8 for odd r), k 2t, 2t+1 (+8 for r >= 2)
        const int k = k0 + 2 * t + ((r >> 1) << 3), m = m0 + g + ((r & 1) << 3);
        split_pair(xs[k * S::XS + m], xs[(k + 1) * S::XS + m], &ah[r], &am[r], &al[r]);
      }
#pragma unroll
      for (int i = 0; i < kNpw; ++i) {
        const int nt = n_first + i * nstep;
        if (nt < S::NT) {
          uint32_t bh[2], bm[2], bl[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 wv = *reinterpret_cast<const float2*>(ws + (nt * 8 + g) * WS + k0 + 2 * t + 8 * r);
            split_pair(wv.x, wv.y, &bh[r], &bm[r], &bl[r]);
          }
          mma_bf16(small[i], al, bh);
          mma_bf16(small[i], am, bm);
          mma_bf16(small[i], ah, bl);
          mma_bf16(small[i], am, bh);
          mma_bf16(small[i], ah, bm);
          mma_bf16(acc[0][i], ah, bh);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kNpw; ++i) {
    const int nt = n_first + i * nstep;
    if (nt < S::NT) {
      const int r0 = nt * 8 + 2 * t;  // c[0], c[1]: rows r0, r0 + 1 at position g; c[2], c[3]: at g + 8
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = acc[0][i][e];
#pragma unroll
        for (int u = 1; u < KU; ++u) sum += acc[u][i][e];
        const int r = r0 + (e & 1);
        pt[r * S::PS + 2 + m0 + g + ((e >> 1) << 3)] = (sum + small[i][e]) + bin[r];
      }
    }
  }
}

// Phase 1 for batch row b, channels c0 .. c0 + CG - 1: the tiles [t_write,
// t_end) of the positions, z and the x2 gate into the group's scratch rows
// (row j: z pairs, then the gate); from one tile early when t_write > 0, for
// the carry. Two barriers a tile. Ends with a barrier: the buffers are free.
template <typename T, int CG>
__device__ void project(const Args& a, unsigned char* smem, int b, int c0, int t_write, int t_end, float* scr) {
  using S = Tile<T, CG>;
  const int D = a.D, L = a.L, kp = a.kp, lq = a.lq;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int WS = kp + S::E;
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + 2 * kp * S::XS;
  float* pt = reinterpret_cast<float*>(ws + S::R * WS);
  float* bin = pt + S::R * S::PS;
  float* gate = bin + S::R;    // (k0, k1, k2, bias) of each projected row
  float* carry = gate + 4 * S::R;  // [2][R][2]: the two positions before tile t, at t & 1

  // The weight rows by cp.async, in the first tile's group (rows of absent
  // channels zero-filled), or one element at a time where rows are not 16-byte
  // aligned; the K padding columns zero.
  const T* wt = static_cast<const T*>(a.w);
  if (a.vec_w) {
    const int chunks = D / S::E;
    for (int i = tid; i < S::R * chunks; i += nth) {
      const int r = i / chunks, ch = i - r * chunks;
      const int c = c0 + r % CG;
      const T* src = c < D ? wt + (size_t)((r / CG) * D + c) * D + ch * S::E : wt;
      cp_async16(ws + r * WS + ch * S::E, src, c < D ? 16 : 0);
    }
    for (int i = tid; i < S::R * (WS - D); i += nth) ws[(i / (WS - D)) * WS + D + i % (WS - D)] = zero<T>();
  } else {
    for (int i = tid; i < S::R * WS; i += nth) {
      const int r = i / WS, d = i - r * WS;
      const int c = c0 + r % CG;
      ws[i] = d < D && c < D ? wt[(size_t)((r / CG) * D + c) * D + d] : zero<T>();
    }
  }
  for (int r = tid; r < S::R; r += nth) {
    const int c = c0 + r % CG, ch = (r / CG) * D + c;
    const bool on = c < D;
    bin[r] = on ? a.b_in[ch] : 0.f;
    gate[4 * r] = on ? a.taps[ch] : 0.f;
    gate[4 * r + 1] = on ? a.taps[3 * D + ch] : 0.f;
    gate[4 * r + 2] = on ? a.taps[6 * D + ch] : 0.f;
    gate[4 * r + 3] = on ? a.bsh[ch] : 0.f;
  }
  for (int i = tid; i < 4 * S::R; i += nth) carry[i] = 0.f;  // p[-2] = p[-1] = 0
  for (int i = tid; i < 2 * (kp - D) * S::XS; i += nth) {  // the K padding rows of both buffers
    const int pad_rows = (kp - D) * S::XS;
    xs[(i / pad_rows) * kp * S::XS + D * S::XS + i % pad_rows] = zero<T>();
  }

  const T* xb = static_cast<const T*>(a.x) + (size_t)b * D * L;
  auto stage = [&](int t, int buf) {
    T* dst = xs + buf * kp * S::XS;
    const int p0 = t * S::TP;
    if (a.vec_in) {
      constexpr int chunks = S::TP / S::E;  // a row's 16-byte chunks
      for (int i = tid; i < D * chunks; i += nth) {
        const int d = i / chunks, p = p0 + (i % chunks) * S::E;
        const int bytes = p < L ? 16 : 0;  // L is a whole number of chunks here
        cp_async16(dst + d * S::XS + (i % chunks) * S::E, xb + (size_t)d * L + (bytes ? p : 0), bytes);
      }
    } else {
      for (int i = tid; i < D * S::TP; i += nth) {
        const int d = i / S::TP, p = i - d * S::TP;
        dst[d * S::XS + p] = p0 + p < L ? xb[(size_t)d * L + p0 + p] : zero<T>();
      }
    }
    cp_async_commit();
  };

  const int t0 = t_write > 0 ? t_write - 1 : 0;
  constexpr int pairs = S::TP / 2;
  stage(t0, 0);
  for (int t = t0; t < t_end; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t_end) {
      stage(t + 1, buf ^ 1);  // the buffer tile t - 1 used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* cin = carry + (t & 1) * 2 * S::R;
    for (int r = tid; r < S::R; r += nth) {
      pt[r * S::PS] = cin[2 * r];
      pt[r * S::PS + 1] = cin[2 * r + 1];
    }
    tile_product<T, CG>(xs + buf * kp * S::XS, ws, kp, pt, bin);
    __syncthreads();
    // The window is read until the next iteration's first barrier; its last
    // two positions go to the other carry, read after that barrier.
    float* cout = carry + ((t + 1) & 1) * 2 * S::R;
    for (int r = tid; r < S::R; r += nth) {
      cout[2 * r] = pt[r * S::PS + S::TP];
      cout[2 * r + 1] = pt[r * S::PS + S::TP + 1];
    }
    if (t >= t_write) {
      for (int i = tid; i < CG * pairs; i += nth) {
        const int j = i / pairs, q = i - j * pairs;
        const int n = t * S::TP + 2 * q;
        if (c0 + j >= D || n >= L) continue;
        const float* p2 = pt + j * S::PS + 2 + 2 * q;  // window column of position n
        const float* p1 = p2 + CG * S::PS;
        const float* pv = p1 + CG * S::PS;
        const float* k2 = gate + 4 * j;
        const float* k1 = k2 + 4 * CG;
        const float* kv = k1 + 4 * CG;
        float g2[2], w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // The other mixers' gate expression: k0 p[n-2] + k1 p[n-1] + k2 p[n] + b.
          g2[e] = k2[0] * p2[e - 2] + k2[1] * p2[e - 1] + k2[2] * p2[e] + k2[3];
          const float x1 = k1[0] * p1[e - 2] + k1[1] * p1[e - 1] + k1[2] * p1[e] + k1[3];
          const float v = kv[0] * pv[e - 2] + kv[1] * pv[e - 1] + kv[2] * pv[e] + kv[3];
          w[e] = n + e < L ? v * x1 : 0.f;
        }
        // Streaming stores: evicted first, so x's tiles keep their place in L2.
        float* row = scr + (size_t)j * 2 * lq;
        __stcs(reinterpret_cast<float2*>(row) + (n >> 1), make_float2(w[0], w[1]));
        __stcs(reinterpret_cast<float2*>(row + lq) + (n >> 1), make_float2(g2[0], g2[1]));
      }
    }
  }
  __syncthreads();
}

// z[m] of a scratch row, zero from ceil(L / 2) on.
__device__ __forceinline__ float2 z_at(const float* row, int m, int L) {
  return 2 * m < L ? __ldcs(reinterpret_cast<const float2*>(row) + m) : make_float2(0.f, 0.f);
}

// One chunk of the output: z'[m] = E[m] + conj(W_M^m) O[m] for 2m < L, times
// the x2 gate g2 (a scratch row), stored at n0.. (n < L).
template <typename T>
__device__ __forceinline__ void out_chunk(T* out, const float* g2, int n0, int L, bool vec_out, const float2* e,
                                          const float2* o, const float2* tw) {
  constexpr int P = Chunk<T>::P;
  float g[P], y[P];
#pragma unroll
  for (int i = 0; i < P; i += 4) {  // the row is lq >= n0 + P floats long
    const float4 u = __ldcs(reinterpret_cast<const float4*>(g2 + n0 + i));
    g[i] = u.x;
    g[i + 1] = u.y;
    g[i + 2] = u.z;
    g[i + 3] = u.w;
  }
#pragma unroll
  for (int p = 0; p < P / 2; ++p) {
    const int m = n0 / 2 + p;
    float2 zz = make_float2(0.f, 0.f);
    if (2 * m < L) zz = cadd(e[pad(m)], cmul(o[pad(m)], cconj(__ldg(&tw[2 * m]))));
    y[2 * p] = zz.x * g[2 * p];
    y[2 * p + 1] = zz.y * g[2 * p + 1];
  }
  if (vec_out && n0 + P <= L) {
    store16(out + n0, y);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (n0 + i < L) store(&out[n0 + i], y[i]);
  }
}

// N <= 16384: one block of 256 threads a (batch row, group), two an SM; phase
// 2 runs G channels at a time, both halves of each in shared memory:
// [G][2][padded(H)] float2, then the quarter table.
template <typename T, int CG, int V>
__global__ void __launch_bounds__(kRowsThreads, 2) inproj_rows(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Chunk<T>::P;
  const int b = blockIdx.x / a.groups;
  const int c0 = (blockIdx.x % a.groups) * CG;
  const int L = a.L, D = a.D, lq = a.lq;
  float* scr = a.scratch + (size_t)blockIdx.x * CG * 2 * lq;
  project<T, CG>(a, smem, b, c0, 0, (L + Tile<T, CG>::TP - 1) / Tile<T, CG>::TP, scr);

  float2* s = reinterpret_cast<float2*>(smem);
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  const int nt = H / V;  // threads of one transform
  const int G = min(CG, (int)blockDim.x / (2 * nt));
  const int hp = padded(H);
  float2* wt = s + (size_t)G * 2 * hp;
  fft_radix::stage_quarter_table(wt, a.tw, H);
  const int Q = (L + P - 1) / P;
  const int live = min(CG, D - c0);
  for (int j0 = 0; j0 < live; j0 += G) {
    const int rows = min(G, live - j0);
    for (int i = threadIdx.x; i < G << log2h; i += blockDim.x) {
      const int g = i >> log2h, m = i & (H - 1);
      const float2 z = g < rows ? z_at(scr + (size_t)(j0 + g) * 2 * lq, m, L) : make_float2(0.f, 0.f);
      float2* row = s + (size_t)g * 2 * hp;
      row[pad(m)] = z;
      row[hp + pad(m)] = cmul(z, __ldg(&a.tw[2 * m]));
    }
    __syncthreads();
    const bool active = (int)threadIdx.x / (2 * nt) < rows;
    float2* x = s + (size_t)min((int)threadIdx.x / nt, 2 * G - 1) * hp;  // row tid / 2nt, half (tid / nt) & 1
    fft_radix::fft<V, false>(x, log2h, threadIdx.x % nt, active, wt);
    for (int i = threadIdx.x; i < rows << log2h; i += blockDim.x) {
      const int g = i >> log2h, k = i & (H - 1);
      float2* row = s + (size_t)g * 2 * hp;
      const float2* kh = a.khat + (size_t)(c0 + j0 + g) * (M + 1);
      spectral_pair(row, hp, k, M, kh, a.tw);
      if (k == 0) spectral_pair(row, hp, H, M, kh, a.tw);
    }
    __syncthreads();
    fft_radix::fft<V, true>(x, log2h, threadIdx.x % nt, active, wt);
    for (int i = threadIdx.x; i < rows * Q; i += blockDim.x) {
      const int g = i / Q, q = i - g * Q;
      const float2* row = s + (size_t)g * 2 * hp;
      T* out = static_cast<T*>(a.out) + ((size_t)b * D + c0 + j0 + g) * L;
      out_chunk(out, scr + (size_t)(j0 + g) * 2 * lq + lq, q * P, L, a.vec_out, row, row + hp, a.tw);
    }
    __syncthreads();
  }
}

// N = 32768 and 65536: one (batch row, group) a cluster of two CTAs of H / 32
// threads (256: two clusters an SM, so one's projection runs beside
// another's transforms; 512). Phase 1: CTA r projects half r of the tiles.
// Phase 2, channel by channel: CTA r holds half r of the transform
// ([padded(H)] float2, then the quarter table), and each writes half of the
// output chunks, reading the other's half through distributed shared memory.
template <typename T, int CG, int THREADS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, THREADS >= 512 ? 1 : 2) inproj_pair(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = Chunk<T>::P;
  constexpr int V = 32;  // H / V = THREADS
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x >> 1;
  const int b = cid / a.groups;
  const int c0 = (cid % a.groups) * CG;
  const int L = a.L, D = a.D, lq = a.lq;
  float* scr = a.scratch + (size_t)cid * CG * 2 * lq;
  const int tiles = (L + Tile<T, CG>::TP - 1) / Tile<T, CG>::TP;
  const int half = (tiles + 1) / 2;
  project<T, CG>(a, smem, b, c0, rank ? half : 0, rank ? tiles : half, scr);
  __threadfence();
  cluster.sync();  // both halves of the scratch rows written; the buffers free

  float2* s = reinterpret_cast<float2*>(smem);
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  float2* wt = s + padded(H);
  fft_radix::stage_quarter_table(wt, a.tw, H);
  const float2* other = cluster.map_shared_rank(s, rank ^ 1);
  const float2* e = rank ? other : s;
  const float2* o = rank ? s : other;
  const int Qo = (L + P - 1) / P;
  const int Qh = (Qo + 1) / 2;
  const int qend = min(Qo, (rank + 1) * Qh);
  for (int j = 0; j < CG && c0 + j < D; ++j) {
    const float* row = scr + (size_t)j * 2 * lq;
    for (int m = threadIdx.x; m < H; m += blockDim.x) {
      const float2 z = z_at(row, m, L);
      s[pad(m)] = rank ? cmul(z, __ldg(&a.tw[2 * m])) : z;
    }
    __syncthreads();
    fft_radix::fft<V, false>(s, log2h, threadIdx.x, true, wt);
    // Pair pass over this half's parity class: k = 2i + rank <= M/2.
    const float2* kh = a.khat + (size_t)(c0 + j) * (M + 1);
    for (int i = threadIdx.x; 2 * i + rank <= H; i += blockDim.x) {
      const int k = 2 * i + rank;
      const int k2 = (M - k) & (M - 1);
      const int pa = pad(k >> 1), pb = pad(k2 >> 1);
      float2 za, zb;
      pair_pass(s[pa], s[pb], k, M, kh, a.tw, &za, &zb);
      s[pa] = za;
      if (k != 0 && k2 != k) s[pb] = zb;
    }
    __syncthreads();
    fft_radix::fft<V, true>(s, log2h, threadIdx.x, true, wt);
    cluster.sync();  // both inverse halves done
    T* out = static_cast<T*>(a.out) + ((size_t)b * D + c0 + j) * L;
    for (int q = rank * Qh + threadIdx.x; q < qend; q += blockDim.x)
      out_chunk(out, row + lq, q * P, L, a.vec_out, e, o, a.tw);
    cluster.sync();  // the other CTA has read this half before the next fill
  }
}

// Set a kernel's dynamic shared memory once per device and size: the first
// eager call of a shape sets it, so a CUDA-graph capture of that shape later
// sets nothing.
struct SmemAttr {
  size_t set[16] = {};
  template <typename K>
  cudaError_t ensure(K kernel, size_t bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 16 && set[dev] >= bytes) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && dev < 16) set[dev] = bytes;
    return err;
  }
};

template <typename T, int CG, int V>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  static SmemAttr attr;
  const int H = 1 << (a.log2n - 2);
  const int G = std::min(CG, kRowsThreads / (2 * (H / V)));
  const size_t fft = ((size_t)G * 2 * padded(H) + quarter(H)) * sizeof(float2);
  const size_t smem = std::max(fft, Tile<T, CG>::bytes(a.kp));  // the phases share the memory
  if (smem > (size_t)kMaxSmemBytes || G < 1) return cudaErrorInvalidValue;
  cudaError_t err = attr.ensure(inproj_rows<T, CG, V>, smem);
  if (err != cudaSuccess) return err;
  inproj_rows<T, CG, V><<<a.B * a.groups, kRowsThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int CG, int THREADS>
cudaError_t launch_pair(const Args& a, cudaStream_t stream) {
  static SmemAttr attr;
  const int H = 1 << (a.log2n - 2);
  const size_t fft = ((size_t)padded(H) + quarter(H)) * sizeof(float2);
  const size_t smem = std::max(fft, Tile<T, CG>::bytes(a.kp));
  if (smem > (size_t)kMaxSmemBytes || H != 32 * THREADS) return cudaErrorInvalidValue;
  cudaError_t err = attr.ensure(inproj_pair<T, CG, THREADS>, smem);
  if (err != cudaSuccess) return err;
  inproj_pair<T, CG, THREADS><<<2 * a.B * a.groups, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int log2h = a.log2n - 2;
  static_assert(group_size(16) == 8 && group_size(15) == 8 && group_size(14) == 16, "group sizes below");
  if (log2h == kPairLog2h) return launch_pair<T, 8, 512>(a, stream);
  if (log2h == kPairLog2h - 1) return launch_pair<T, 8, 256>(a, stream);
  switch (fft_radix::values_per_thread(1 << log2h)) {
    case 2: return launch_rows<T, 16, 2>(a, stream);
    case 4: return launch_rows<T, 16, 4>(a, stream);
    case 8: return launch_rows<T, 16, 8>(a, stream);
    case 16: return launch_rows<T, 16, 16>(a, stream);
    default: return launch_rows<T, 16, 32>(a, stream);
  }
}

__host__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

extern "C" {

// Bytes of global scratch the call needs: two float32 rows of L rounded up
// to 8 (z pairs, the x2 gate) per (batch row, channel slot of its group).
long long mixer_inproj_fwd_scratch_bytes(int B, int D, int L, int log2n) {
  const int cg = group_size(log2n);
  return (long long)B * ((D + cg - 1) / cg) * cg * 2 * round_up(L, 8) * (long long)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a shape the kernel does not take,
// such as a D whose tiles and weight rows outgrow shared memory).
int mixer_inproj_fwd(const void* x, const void* w, const float* b_in, const float* taps, const float* bsh,
                     const void* khat, const void* tw, void* scratch, void* out, int B, int D, int L, int log2n,
                     int dtype, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > kPairLog2h + 2 || (1 << log2n) < 2 * L || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : 2;
  const int P = 16 / size;
  const int cg = group_size(log2n);
  const bool rows16 = (long long)L * size % 16 == 0;
  Args a{x, w, b_in, taps, bsh, static_cast<const float2*>(khat), static_cast<const float2*>(tw),
         static_cast<float*>(scratch), out, B, D, L, log2n, round_up(D, 16), (D + cg - 1) / cg, round_up(L, 8),
         rows16 && ((uintptr_t)x & 15) == 0, D * size % 16 == 0 && ((uintptr_t)w & 15) == 0,
         L % P == 0 && ((uintptr_t)out & 15) == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, st);
  return (int)launch<__nv_bfloat16>(a, st);
}

}  // extern "C"
