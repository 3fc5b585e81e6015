// Complex power-of-two FFTs of length H in shared memory, as passes of radix 2,
// 4, 8 or 16 done in registers (Stockham order: natural order in and out).
//
// A length-H transform is log2(H) radix-2 stages; here it is at most four
// passes: the remainder radix 2^(log2 H mod 4) first (at Ns = 1 it needs no
// twiddles), then radix 16. In a pass each of the H/V threads of a transform
// holds V values in registers (V = values_per_thread(H), a function of H only,
// so a transform's arithmetic never depends on which others share its block).
// It takes them as V/R groups j = t + g * (H/V) of R values x[j + r * H/R],
// turns value r by W_{Ns R}^{r (j mod Ns)}, runs a length-R DFT in registers
// (radix-2 decimation in frequency with constant twiddles, then a bit reversal
// that is only a renaming of registers), and writes value r to
// x[(j - j mod Ns) R + j mod Ns + r Ns]. In place: all reads of a pass, a
// barrier, all writes, a barrier. So a pass reads and writes the row in shared
// memory once, where a radix-2 stage did the same for one of log2(H) stages.
//
// Shared memory is padded: element p lives at p + p / 16, which spreads the
// strided writes of the early passes (stride R float2 at Ns = 1) over the
// banks. Twiddles come from a quarter table wt[b] = W_H^b, b < H/4, staged
// once a block from the host's float64-built table; W_H^i is wt[i mod H/4]
// turned by (-i)^(i div H/4), which is exact.
//
// Last, the FFT conv's pair pass over a row held as two such transforms
// (`spectral_pair`, `half_pairs`), shared by the kernels built on them.
//
// The numpy model of this plan is tests/test_torch_port_fft_plan.py.

#pragma once

#include "mixer_common.cuh"

namespace fft_radix {

using mixer_common::cadd;
using mixer_common::cconj;
using mixer_common::cmul;
using mixer_common::csub;

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n >> 1); }

__host__ __device__ constexpr int rev_bits(int x, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

// Values a thread holds in a pass: H below 16; 16; 32 from H = 4096 on, so a
// block stays at <= 512 threads.
__host__ __device__ constexpr int values_per_thread(int H) { return H < 16 ? H : (H >= 4096 ? 32 : 16); }

// Padded length of one transform of H values, and the padded index.
__host__ __device__ constexpr int padded(int H) { return H + (H >> 4); }
__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

// Quarter-table length (at least 1).
__host__ __device__ constexpr int quarter(int H) { return H >= 4 ? H >> 2 : 1; }

// cos and sin of 2 pi k / 16.
__host__ __device__ constexpr float cos16(int k) {
  constexpr float c1 = 0.923879532511286756f, s1 = 0.382683432365089772f, h = 0.707106781186547524f;
  switch (k & 15) {
    case 0: return 1.f;
    case 1: return c1;
    case 2: return h;
    case 3: return s1;
    case 4: return 0.f;
    case 5: return -s1;
    case 6: return -h;
    case 7: return -c1;
    case 8: return -1.f;
    case 9: return -c1;
    case 10: return -h;
    case 11: return -s1;
    case 12: return 0.f;
    case 13: return s1;
    case 14: return h;
    default: return c1;
  }
}
__host__ __device__ constexpr float sin16(int k) { return cos16(k - 4); }

// a * exp(-+2 pi i N / DEN) for DEN in {2, 4, 8, 16}: forward (-) or inverse
// (+). Exact at multiples of a quarter turn; everything is decided at compile
// time.
template <bool INV, int N, int DEN>
__device__ __forceinline__ float2 rotate(float2 a) {
  constexpr int k = (N * (16 / DEN)) & 15;
  if constexpr (k == 0) {
    return a;
  } else if constexpr (k == 8) {
    return make_float2(-a.x, -a.y);
  } else if constexpr (k == 4) {
    return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  } else if constexpr (k == 12) {
    return INV ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
  } else {
    constexpr float c = cos16(k), s = INV ? sin16(k) : -sin16(k);
    return cmul(a, make_float2(c, s));
  }
}

// The butterflies of one radix-2 DIF stage of span SPAN, from index I on.
template <int R, bool INV, int SPAN, int I>
__device__ __forceinline__ void butterflies(float2* v) {
  if constexpr (I < R) {
    if constexpr ((I & SPAN) == 0) {
      const float2 a = v[I], b = v[I + SPAN];
      v[I] = cadd(a, b);
      v[I + SPAN] = rotate<INV, (I & (SPAN - 1)), 2 * SPAN>(csub(a, b));
    }
    butterflies<R, INV, SPAN, I + 1>(v);
  }
}

template <int R, bool INV, int SPAN>
__device__ __forceinline__ void dif_spans(float2* v) {
  if constexpr (SPAN >= 1) {
    butterflies<R, INV, SPAN, 0>(v);
    dif_spans<R, INV, SPAN / 2>(v);
  }
}

template <int R, int I>
__device__ __forceinline__ void bit_reverse(float2* v) {
  if constexpr (I < R) {
    constexpr int r = rev_bits(I, ilog2(R));
    if constexpr (I < r) {
      const float2 t = v[I];
      v[I] = v[r];
      v[r] = t;
    }
    bit_reverse<R, I + 1>(v);
  }
}

// In-register length-R DFT of v[0..R), natural order in and out: radix-2
// decimation in frequency, then the bit reversal, all indices constant, so v
// stays in registers.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2* v) {
  dif_spans<R, INV, R / 2>(v);
  bit_reverse<R, 0>(v);
}

// W_H^i (forward) or its conjugate (inverse) from the quarter table.
template <bool INV>
__device__ __forceinline__ float2 twiddle(const float2* wt, int i, int log2q) {
  const float2 w = wt[i & ((1 << log2q) - 1)];
  float2 r;
  switch ((i >> log2q) & 3) {
    case 0: r = w; break;
    case 1: r = make_float2(w.y, -w.x); break;
    case 2: r = make_float2(-w.x, -w.y); break;
    default: r = make_float2(-w.y, w.x); break;
  }
  return INV ? cconj(r) : r;
}

// Fill the quarter table wt[b] = W_H^b = tw[4b] (tw[j] = exp(-2 pi i j / 4H)).
__device__ __forceinline__ void stage_quarter_table(float2* wt, const float2* tw, int H) {
  for (int b = threadIdx.x; b < (H >> 2); b += blockDim.x) wt[b] = __ldg(&tw[4 * b]);
}

// One Stockham pass of radix R = 2^LR over the padded transform x of H =
// 2^log2h values, after passes whose radices multiply to Ns = 2^log2ns (see
// the header). Every thread of the block calls it; `active` threads move data.
template <int LR, int V, bool INV>
__device__ __forceinline__ void pass(float2* x, int log2h, int log2ns, int t, bool active, const float2* wt) {
  constexpr int R = 1 << LR;
  if constexpr (R <= V) {
    constexpr int G = V / R;
    const int log2t = log2h - ilog2(V);  // H / V threads a transform
    const int ns = 1 << log2ns;
    float2 v[V];
    if (active) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = t + (g << log2t);
#pragma unroll
        for (int r = 0; r < R; ++r) v[g * R + r] = x[pad(j + (r << (log2h - LR)))];
        if (log2ns > 0) {
          // W_{Ns R}^{r (j mod Ns)} = W_H^{r (j mod Ns) H / (Ns R)}
          const int step = (j & (ns - 1)) << (log2h - log2ns - LR);
#pragma unroll
          for (int r = 1; r < R; ++r) v[g * R + r] = cmul(v[g * R + r], twiddle<INV>(wt, r * step, log2h - 2));
        }
        dft<R, INV>(&v[g * R]);
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = t + (g << log2t);
        const int k = j & (ns - 1);
        const int base = ((j - k) << LR) + k;
#pragma unroll
        for (int r = 0; r < R; ++r) x[pad(base + (r << log2ns))] = v[g * R + r];
      }
    }
    __syncthreads();
  }
}

// Length-H = 2^log2h transform of the padded x in place, natural order in and
// out; forward (exp(-)) or unnormalized inverse (exp(+)). t is the thread's
// index among the H/V threads of this transform. Ends with a barrier.
template <int V, bool INV>
__device__ void fft(float2* x, int log2h, int t, bool active, const float2* wt) {
  int lr = log2h <= 4 ? log2h : ((log2h & 3) ? (log2h & 3) : 4);
  for (int log2ns = 0; log2ns < log2h; log2ns += lr, lr = 4) {
    switch (lr) {
      case 1: pass<1, V, INV>(x, log2h, log2ns, t, active, wt); break;
      case 2: pass<2, V, INV>(x, log2h, log2ns, t, active, wt); break;
      case 3: pass<3, V, INV>(x, log2h, log2ns, t, active, wt); break;
      default: pass<4, V, INV>(x, log2h, log2ns, t, active, wt); break;
    }
  }
}

// The pair pass of the FFT conv for bins (k, M - k) of one row whose
// spectrum lies in two transforms of H = M/2 at stride hp (bin k at half
// k & 1, index k / 2): real-FFT split, times khat, real-IFFT merge.
__device__ __forceinline__ void spectral_pair(float2* row, int hp, int k, int M, const float2* kh, const float2* tw) {
  const int k2 = (M - k) & (M - 1);
  const int pa = (k & 1) * hp + pad(k >> 1);
  const int pb = (k2 & 1) * hp + pad(k2 >> 1);
  float2 za, zb;
  mixer_common::pair_pass(row[pa], row[pb], k, M, kh, tw, &za, &zb);
  row[pa] = za;
  if (k != 0 && k2 != k) row[pb] = zb;
}

// The same pass over the half `rank` alone, as a two-CTA cluster holds a row
// (one half a CTA, in s): bins k = 2j + rank <= M/2, whose partners M - k
// have k's parity and so lie in the same half. Every thread of the CTA calls it.
__device__ __forceinline__ void half_pairs(float2* s, int rank, int H, const float2* kh, const float2* tw) {
  const int M = 2 * H;
  for (int j = threadIdx.x; 2 * j + rank <= H; j += blockDim.x) {
    const int k = 2 * j + rank;
    const int k2 = (M - k) & (M - 1);
    const int pa = pad(k >> 1), pb = pad(k2 >> 1);
    float2 za, zb;
    mixer_common::pair_pass(s[pa], s[pb], k, M, kh, tw, &za, &zb);
    s[pa] = za;
    if (k != 0 && k2 != k) s[pb] = zb;
  }
}

}  // namespace fft_radix
