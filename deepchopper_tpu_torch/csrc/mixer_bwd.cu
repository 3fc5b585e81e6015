// Fused Hyena mixer, backward: recompute the forward's gates and spectra, form
// the gate cotangents, apply the short-conv adjoint and take the batch sums.
//
// Replaces the Pallas TPU kernel `_mixer_bwd_kernel`
// (deepchopper_tpu/ops/pallas_fft.py:1256), driven there by `mixer_bwd_pallas`.
// Same contract, batch-major:
//
//   proj   (B, 3D, L) [x2 | x1 | v] raw in_proj output, float32 or bfloat16
//   dy     (B, D, L)  cotangent of the mixer output, proj's dtype
//   taps   (3, 3D)    float32, tap t multiplies x[n - (2 - t)] (zero for n < 0)
//   bsh    (3D,)      float32 short-conv bias
//   khat   (D, M + 1) complex64, the forward's filter spectrum at N = 2M (1/N and
//                     the skip bias folded in; mixer_fwd.cu)
//   tw     (M + 1,)   complex64, tw[j] = exp(-2 pi i j / N)
//   dproj  (B, 3D, L) proj's dtype out: the short-conv adjoint of the gate
//                     cotangents, dproj[s] = k2 dg[s] + k1 dg[s+1] + k0 dg[s+2]
//                     (dg zero at s >= L), rounded once from float32. (The JAX
//                     kernel rounds the cotangents to dy's dtype first.)
//   dkhat  (D, M + 1) complex64 out: sum over the batch of conj(X_w[k]) X_dz[k]
//   dsh    (4, 3D)    float32 out: rows 0-2 the tap sums sum_{b,s} dg[s] x[s+t-2],
//                     row 3 the bias sums sum_{b,s} dg[s], per gate channel.
//
// Math, per (row b, channel d), gates short-convolved in float32 as in the
// forward, w = v x1, dz = dy x2, X_w = rfft_N(w), X_dz = rfft_N(dz):
//   z   = IDFT(khat X_w)[:L]            (the forward's long conv)
//   dw  = IDFT(conj(khat) X_dz)[:L]     (circular correlation; exact as N >= 2L)
//   dx2 = dy z,   dx1 = dw v,   dv = dw x1
//   dkhat[d, k] += conj(X_w[k]) X_dz[k]
// IDFT is unnormalized (1/N lives in khat). The wrapper turns dkhat into
// (dk_long, dbias) through autograd of the filter spectrum, as the JAX package
// turns its dK into them through jax.vjp(khat_scrambled).
//
// What bounds it on an H100. Operations: four real FFTs of length N = 2L a row
// (two forward, two inverse), the spectral products and the gate recompute,
// about twice the forward's flops on the CUDA cores (67 TFLOP/s). Bytes: 4
// reads (x2, x1, v, dy) and 3 writes (dproj) of a (B, D, L) stream, 14 B per
// token-channel in bfloat16. At the ladder's widths the operations bound it
// (chip_smoke.py: mixer_bwd_bound).
//
// Design, against the four costs of the radix-2 kernel this replaces:
//  1. The PyTorch tail. The gate cotangents never leave the SM: after the
//     output pass each thread leaves dx2, dx1 and dv of its positions in the
//     shared-memory slots it has just read (slot m of three of the four
//     inverse halves holds positions 2m, 2m+1 of one gate), so a barrier
//     later the adjoint pass reads dg[s..s+P+1] across chunk, warp and row
//     edges and stores dproj as 16-byte vectors. The tap and bias sums are
//     taken in the output pass from the raw proj values the gate loader
//     holds. Only dproj (B, 3D, L), the partials and the small outputs are
//     written; no (B, 3D, L) float32 tensor.
//  2. Radix-2 stages. Every transform is an `fft_radix.cuh` transform: radix
//     2-16 passes in registers, Stockham order, natural order in and out,
//     with mixer_fwd.cu's half-length packing (z[m] = x[2m] + i x[2m+1]) and
//     its two halves (half 0 = z, half 1 = z W_M^m give the even and odd bins;
//     bins k and M - k share a half).
//  3. The serial w -> dz order. Both forward spectra are taken together and
//     one pair pass over (k, M - k) forms khat X_w (the spectrum of z),
//     conj(khat) X_dz (of dw) and the dkhat terms; both inverses follow.
//     X_w leaves the SM only at N = 65536, where one half of one signal fills
//     a CTA.
//  4. Small blocks, scalar loads. Gates are read as 16-byte vectors (8
//     bfloat16 or 4 float32 positions), the two positions before a chunk from
//     the lane before (__shfl_up_sync), with a scalar path where a row is not
//     16-byte aligned or L is not a whole number of chunks. Blocks have at
//     least 256 threads.
//
// Layouts by N (the wrapper's `mixer_bwd_plan` reports which one a call runs):
//   * rows, N <= 8192 (L <= 4096): a block takes G batch rows of one channel
//     at a time, each row's four halves (w 0, w 1, dz 0, dz 1) in shared
//     memory, 4 H / V threads a row, G = 256 / (4 H / V) rows below N = 4096
//     and 1 from there (512 threads at N = 8192, ~105 KB).
//   * pair, N = 16384 and 32768 (L <= 16384): a cluster of two CTAs takes one
//     row; CTA r holds half r of both signals (~70 and ~139 KB) and
//     transforms them at once, 2 H / 32 threads. The pair pass stays within a
//     half; the CTAs meet in the output pass through distributed shared
//     memory, as mixer_fwd_pair does. At N = 16384 it fits two CTAs an SM
//     where one row a block fitted one (213 KB), and measured faster on the
//     H100 (PERF.md).
//   * park, N = 65536 (L <= 32768): the same cluster, but one half of one
//     signal is ~139 KB, so the CTA transforms w's half, parks it in its own
//     scratch row (L2-resident: ~17 MB for 132 CTAs), transforms dz's half,
//     and the pair pass leaves z's spectrum in shared memory and dw's in the
//     park. z's inverse, output and adjoint (dx2) run first, then dw's (dx1,
//     dv).
//
// Batch sums without atomics, bitwise repeatable. Block (j, d) walks a fixed
// set of rows of channel d (row sets j, j + groups, ...; groups chosen so the
// grid fills the card about twice). Each dkhat bin is carried by the same
// thread across those rows in shared memory and written once a block (at N =
// 65536, where a CTA's shared memory holds one half, in the block's partial
// row in global memory, which the same thread updates row after row); the 12
// short-conv sums of its three gate channels are carried in registers and
// reduced once a block in a fixed order. A second kernel sums the partials in
// block order.

#include <stdint.h>

#include <cooperative_groups.h>

#include "fft_radix.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace mixer_common;
using fft_radix::pad;
using fft_radix::padded;
using fft_radix::quarter;

constexpr int kPairLog2h = 12;  // N = 16384 and 32768: two CTAs a row, both signals' halves in each
constexpr int kParkLog2h = 14;  // N = 65536: two CTAs a row, w's half parked
constexpr int kMaxLog2h = 14;   // N = 65536, L = 32768: the widest transform
constexpr int kMinThreads = 256;
constexpr int kPairThreads = 512;
constexpr int kRowsMinBlocks = 2;  // blocks an SM the 256-thread rows kernels are built for
constexpr int kSums = 12;  // per gate x2, x1, v: the three tap sums, then the bias sum
constexpr int kSMs = 132;            // H100 SXM
constexpr int kSmemPerSM = 233472;   // 228 KB of shared memory an SM
constexpr int kWaves = 2;            // row groups: about two waves of blocks on the card

enum Kind { kRows = 0, kPair = 1, kPark = 2 };

struct Plan {
  int kind;
  int V;        // values a thread holds in a transform pass
  int G;        // rows a block holds at once (rows); 1 (pair, park)
  int threads;  // a block (a CTA)
  int ctas;     // a block's CTAs
  int groups;   // blocks of one channel, each with its own rows
  size_t smem;  // dynamic shared memory of a CTA
};

struct Args {
  const void* proj;
  const void* dy;
  const float* taps;
  const float* bsh;
  const float2* khat;
  const float2* tw;
  void* dproj;
  float2* part;  // (groups, D, M + 1) dkhat partials
  float* sums;   // (groups, D, 2, kSums) short-conv sums, one set a CTA
  float2* park;  // park: (groups, D, 2, H)
  int B;
  int D;
  int L;
  int log2n;
  int G;
  int groups;
  bool vec_in;   // proj and dy rows start on 16 bytes and L is a whole number of chunks
  bool vec_out;  // the same for dproj
};

// x[i] = row[n0 - 2 + i] for i < P + 2, zero outside [0, L): the chunk and the
// two positions before it. The lane before holds the chunk n0 - P of the same
// row, except at a warp's first lane and a row's first chunk, which read the
// two positions from memory. Every lane of the warp calls it (L = 0 on idle
// lanes).
template <typename T>
__device__ __forceinline__ void raw_chunk(const T* row, int n0, int L, bool vec, float* x) {
  constexpr int P = Chunk<T>::P;
  load_chunk(row, n0, L, vec, x + 2);
  float m2 = __shfl_up_sync(0xffffffffu, x[P], 1);
  float m1 = __shfl_up_sync(0xffffffffu, x[P + 1], 1);
  if ((threadIdx.x & 31) == 0 || n0 == 0) {
    m2 = n0 >= 2 && n0 - 2 < L ? to_f(row[n0 - 2]) : 0.f;
    m1 = n0 >= 1 && n0 - 1 < L ? to_f(row[n0 - 1]) : 0.f;
  }
  x[0] = m2;
  x[1] = m1;
}

// The short-convolved gate at position n0 + i from raw_chunk's x.
__device__ __forceinline__ float gate_at(const Gate& g, const float* x, int i) {
  return g.k0 * x[i] + g.k1 * x[i + 1] + g.k2 * x[i + 2] + g.b;
}

struct Gates {
  Gate x2, x1, v;
  __device__ Gates(const Args& a, int c)
      : x2(a.taps, a.bsh, a.D, c), x1(a.taps, a.bsh, a.D, a.D + c), v(a.taps, a.bsh, a.D, 2 * a.D + c) {}
};

// The rows of batch row b, channel c: the three gates' proj rows, dy, and the
// three dproj rows.
template <typename T>
struct Rows {
  const T* x2;
  const T* x1;
  const T* v;
  const T* dy;
  T* d2;
  T* d1;
  T* dv;
  __device__ Rows(const Args& a, int b, int c) {
    const size_t gate = (size_t)a.D * a.L;
    const size_t off = (size_t)b * 3 * gate + (size_t)c * a.L;
    x2 = static_cast<const T*>(a.proj) + off;
    x1 = x2 + gate;
    v = x1 + gate;
    dy = static_cast<const T*>(a.dy) + ((size_t)b * a.D + c) * a.L;
    d2 = static_cast<T*>(a.dproj) + off;
    d1 = d2 + gate;
    dv = d1 + gate;
  }
};

// One chunk of both packed signals, z[m] = s[2m] + i s[2m+1] for m = n0/2 + p
// < H, s = w = v x1 and s = dz = dy x2 (zero at n >= L): into half 0 (z) and
// half 1 (z W_M^m) of each; a null pointer skips that half, two skip that
// signal's loads.
template <typename T>
__device__ __forceinline__ void fill_chunk(const Rows<T>& r, int n0, int L, bool vec, const Gates& gs,
                                           const float2* twm, int H, float2* w0, float2* w1, float2* d0, float2* d1) {
  constexpr int P = Chunk<T>::P;
  float w[P], d[P];
  if (w0 || w1) {
    float a[P + 2], b[P + 2];
    raw_chunk(r.x1, n0, L, vec, a);
    raw_chunk(r.v, n0, L, vec, b);
#pragma unroll
    for (int i = 0; i < P; ++i) w[i] = n0 + i < L ? gate_at(gs.v, b, i) * gate_at(gs.x1, a, i) : 0.f;
  }
  if (d0 || d1) {
    float a[P + 2], y[P];
    raw_chunk(r.x2, n0, L, vec, a);
    load_chunk(r.dy, n0, L, vec, y);
#pragma unroll
    for (int i = 0; i < P; ++i) d[i] = n0 + i < L ? y[i] * gate_at(gs.x2, a, i) : 0.f;
  }
  if (L == 0) return;
#pragma unroll
  for (int p = 0; p < P / 2; ++p) {
    const int m = n0 / 2 + p;
    if (m < H) {
      if (w0 || w1) {
        const float2 z = make_float2(w[2 * p], w[2 * p + 1]);
        if (w0) w0[pad(m)] = z;
        if (w1) w1[pad(m)] = cmul(z, twm[p]);
      }
      if (d0 || d1) {
        const float2 z = make_float2(d[2 * p], d[2 * p + 1]);
        if (d0) d0[pad(m)] = z;
        if (d1) d1[pad(m)] = cmul(z, twm[p]);
      }
    }
  }
}

// sums[0..2] += dg[i] x[s + t - 2], sums[3] += dg[i], over the chunk.
template <int P>
__device__ __forceinline__ void add_sums(float* sums, const float* dg, const float* x) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    sums[0] += dg[i] * x[i];
    sums[1] += dg[i] * x[i + 1];
    sums[2] += dg[i] * x[i + 2];
    sums[3] += dg[i];
  }
}

// dst[pad(m)] = (dg[2p], dg[2p+1]) for m = n0/2 + p < H.
template <int P>
__device__ __forceinline__ void put_pairs(float2* dst, int n0, int H, const float* dg) {
#pragma unroll
  for (int p = 0; p < P / 2; ++p) {
    const int m = n0 / 2 + p;
    if (m < H) dst[pad(m)] = make_float2(dg[2 * p], dg[2 * p + 1]);
  }
}

// The output pass of one chunk. From the inverse halves (E, O) of z (ez, oz)
// and of dw (ed, od), s'[m] = E[m] + conj(W_M^m) O[m] for 2m < L: dx2 = dy z;
// dx1 = dw v, dv = dw x1 (all zero at n >= L). Adds the chunk's short-conv
// sums and leaves each gate cotangent in its slots (dst2, dst1, dstv), which
// this thread alone has read. ez null skips z's part, ed null dw's.
template <typename T>
__device__ __forceinline__ void out_chunk(const Rows<T>& r, int n0, int L, bool vec, const Gates& gs,
                                          const float2* twc, int H, const float2* ez, const float2* oz,
                                          const float2* ed, const float2* od, float* sums, float2* dst2, float2* dst1,
                                          float2* dstv) {
  constexpr int P = Chunk<T>::P;
  if (ez) {
    float x[P + 2], y[P], g[P];
    raw_chunk(r.x2, n0, L, vec, x);
    load_chunk(r.dy, n0, L, vec, y);
#pragma unroll
    for (int p = 0; p < P / 2; ++p) {
      const int m = n0 / 2 + p;
      float2 z = make_float2(0.f, 0.f);
      if (2 * m < L) z = cadd(ez[pad(m)], cmul(oz[pad(m)], twc[p]));
      g[2 * p] = n0 + 2 * p < L ? y[2 * p] * z.x : 0.f;
      g[2 * p + 1] = n0 + 2 * p + 1 < L ? y[2 * p + 1] * z.y : 0.f;
    }
    add_sums<P>(sums, g, x);
    if (L > 0) put_pairs<P>(dst2, n0, H, g);
  }
  if (ed) {
    float a[P + 2], b[P + 2], g1[P], gv[P];
    raw_chunk(r.x1, n0, L, vec, a);
    raw_chunk(r.v, n0, L, vec, b);
#pragma unroll
    for (int p = 0; p < P / 2; ++p) {
      const int m = n0 / 2 + p;
      float2 dw = make_float2(0.f, 0.f);
      if (2 * m < L) dw = cadd(ed[pad(m)], cmul(od[pad(m)], twc[p]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * p + e;
        const float s = n0 + i < L ? (e ? dw.y : dw.x) : 0.f;
        g1[i] = s * gate_at(gs.v, b, i);
        gv[i] = s * gate_at(gs.x1, a, i);
      }
    }
    add_sums<P>(sums + 4, g1, a);
    add_sums<P>(sums + 8, gv, b);
    if (L > 0) {
      put_pairs<P>(dst1, n0, H, g1);
      put_pairs<P>(dstv, n0, H, gv);
    }
  }
}

// dproj of one chunk of one gate row from its cotangent slots:
// out[s] = k2 dg[s] + k1 dg[s+1] + k0 dg[s+2], dg zero at s >= L.
template <typename T>
__device__ __forceinline__ void adjoint_chunk(const float2* slots, int n0, int L, bool vec, const Gate& gt, T* out) {
  constexpr int P = Chunk<T>::P;
  float d[P + 2], y[P];  // dg[n0 .. n0 + P + 1]: the chunk's P / 2 slots and the one after
#pragma unroll
  for (int p = 0; p <= P / 2; ++p) {
    const int m = n0 / 2 + p;
    const float2 v = 2 * m < L ? slots[pad(m)] : make_float2(0.f, 0.f);
    d[2 * p] = v.x;
    d[2 * p + 1] = 2 * m + 1 < L ? v.y : 0.f;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) y[i] = gt.k2 * d[i] + gt.k1 * d[i + 1] + gt.k0 * d[i + 2];
  if (vec && n0 + P <= L) {
    store16(out + n0, y);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (n0 + i < L) store(&out[n0 + i], y[i]);
  }
}

// The pair (k, M - k) of both signals: X_w and X_dz from their packed spectra
// (wa, wb and da, db at bins k and (M - k) mod M), replaced by the packed
// spectra of z (khat X_w) and dw (conj(khat) X_dz); ta, tb = the dkhat terms
// conj(X_w) X_dz of bins k and M - k.
__device__ __forceinline__ void pair_bwd(float2& wa, float2& wb, float2& da, float2& db, int k, int M,
                                         const float2* kh, const float2* tw, float2& ta, float2& tb) {
  float2 xk, xmk, dk, dmk;
  rfft_split(wa, wb, k, tw, &xk, &xmk);
  rfft_split(da, db, k, tw, &dk, &dmk);
  ta = cmul(cconj(xk), dk);
  tb = cmul(cconj(xmk), dmk);
  const float2 hk = __ldg(&kh[k]), hmk = __ldg(&kh[M - k]);
  rfft_merge(cmul(xk, hk), cmul(xmk, hmk), k, tw, &wa, &wb);
  rfft_merge(cmul(dk, cconj(hk)), cmul(dmk, cconj(hmk)), k, tw, &da, &db);
}

// The pair pass at (k, M - k) on one row whose halves lie at w (w's) and d
// (dz's), hp apart (bin k in half k & 1 at index k / 2); adds the dkhat terms.
__device__ __forceinline__ void pair_rows(float2* w, float2* d, int hp, int k, int M, const float2* kh,
                                          const float2* tw, float2& acc_a, float2& acc_b) {
  const int k2 = (M - k) & (M - 1);
  const int pa = (k & 1) * hp + pad(k >> 1);
  const int pb = (k2 & 1) * hp + pad(k2 >> 1);
  float2 wa = w[pa], wb = w[pb], da = d[pa], db = d[pb], ta, tb;
  pair_bwd(wa, wb, da, db, k, M, kh, tw, ta, tb);
  w[pa] = wa;
  d[pa] = da;
  if (k != 0 && k2 != k) {
    w[pb] = wb;
    d[pb] = db;
  }
  acc_a = cadd(acc_a, ta);
  if (M - k != k) acc_b = cadd(acc_b, tb);
}

// A CTA's 12 sums, reduced over its threads in a fixed order (warp butterfly,
// then warps in order) and written once.
__device__ __forceinline__ void block_sums(float* sums, float* red, float* out) {
#pragma unroll
  for (int j = 0; j < kSums; ++j) {
    float v = sums[j];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    sums[j] = v;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < kSums; ++j) red[warp * kSums + j] = sums[j];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float v = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += red[w * kSums + threadIdx.x];
    out[threadIdx.x] = v;
  }
}

// N <= 8192: G rows of channel c at a time, each row's four halves [w 0 | w 1
// | dz 0 | dz 1] of padded(H) float2 in shared memory, then the quarter table,
// the dkhat slots and the sums' reduction buffer. All threads fill, transform
// (4G transforms of H / V threads), run the pair pass, output and adjoint.
// Pair-pass item i (row i / H, bin k = i mod H) adds into slot i mod S, S =
// max(H, threads): a slot is always the same thread's, and bin k's slots are
// k, k + H, ... (k = 0 also takes bin H, into its own slots).
template <typename T, int V, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == kMinThreads ? kRowsMinBlocks : 1) mixer_bwd_rows(Args a) {
  extern __shared__ float2 s[];
  constexpr int P = Chunk<T>::P;
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  const int L = a.L;
  const int D = a.D;
  const int nt = H / V;  // threads of one transform
  const int G = a.G;
  const int nthreads = THREADS;
  const int S = max(H, nthreads);
  const int hp = padded(H);
  float2* wt = s + (size_t)G * 4 * hp;
  float2* acc_a = wt + quarter(H);
  float2* acc_b = acc_a + S;
  float2* acc_h = acc_b + S;  // S / H slots of bin H
  float* red = reinterpret_cast<float*>(acc_h + S / H);
  const int c = blockIdx.x % D;
  const int grp = blockIdx.x / D;
  const Gates gs(a, c);
  const float2* kh = a.khat + (size_t)c * (M + 1);
  fft_radix::stage_quarter_table(wt, a.tw, H);
  for (int i = threadIdx.x; i < 2 * S + S / H; i += nthreads) acc_a[i] = make_float2(0.f, 0.f);
  float sums[kSums] = {};

  // Chunks of P positions covering [0, 2H) (a power of two, >= L), per row.
  const int log2q = max(0, log2h + 1 - fft_radix::ilog2(P));
  const int items = G << log2q;
  const int sets = (a.B + G - 1) / G;
  for (int set = grp; set < sets; set += a.groups) {
    const int b0 = set * G;
    __syncthreads();  // the last set's adjoint reads are done
    for (int i0 = 0; i0 < items; i0 += nthreads) {
      const int i = i0 + threadIdx.x;
      const int g = i >> log2q, q = i & ((1 << log2q) - 1);
      const bool on = i < items && b0 + g < a.B;
      float2 twm[P / 2];
      chunk_twiddles<P, false>(a.tw, q * P, on ? H : 0, twm);
      const Rows<T> r(a, min(b0 + g, a.B - 1), c);
      float2* row = s + (size_t)min(g, G - 1) * 4 * hp;
      fill_chunk(r, q * P, on ? L : 0, a.vec_in, gs, twm, H, row, row + hp, row + 2 * hp, row + 3 * hp);
    }
    __syncthreads();
    const int x = threadIdx.x / nt;  // transform: row x / 4, half x % 4
    const bool active = b0 + x / 4 < a.B;
    fft_radix::fft<V, false>(s + (size_t)x * hp, log2h, threadIdx.x % nt, active, wt);

    for (int i = threadIdx.x; i < G << log2h; i += nthreads) {
      const int g = i >> log2h, k = i & (H - 1);
      if (b0 + g >= a.B) continue;
      float2* row = s + (size_t)g * 4 * hp;
      const int slot = i & (S - 1);
      pair_rows(row, row + 2 * hp, hp, k, M, kh, a.tw, acc_a[slot], acc_b[slot]);
      if (k == 0) {
        float2 unused = make_float2(0.f, 0.f);
        pair_rows(row, row + 2 * hp, hp, H, M, kh, a.tw, acc_h[slot >> log2h], unused);
      }
    }
    __syncthreads();
    fft_radix::fft<V, true>(s + (size_t)x * hp, log2h, threadIdx.x % nt, active, wt);

    // Output pass: dx2 -> slots of w 0, dx1 -> w 1, dv -> dz 0.
    for (int i0 = 0; i0 < items; i0 += nthreads) {
      const int i = i0 + threadIdx.x;
      const int g = i >> log2q, q = i & ((1 << log2q) - 1);
      const int Lr = i < items && b0 + g < a.B ? L : 0;
      float2 twc[P / 2];
      chunk_twiddles<P, true>(a.tw, q * P, q * P < Lr ? H : 0, twc);
      const Rows<T> r(a, min(b0 + g, a.B - 1), c);
      float2* row = s + (size_t)min(g, G - 1) * 4 * hp;
      out_chunk(r, q * P, Lr, a.vec_in, gs, twc, H, row, row + hp, row + 2 * hp, row + 3 * hp, sums, row, row + hp,
                row + 2 * hp);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < items; i += nthreads) {
      const int g = i >> log2q, q = i & ((1 << log2q) - 1);
      if (b0 + g >= a.B || q * P >= L) continue;
      const Rows<T> r(a, b0 + g, c);
      const float2* row = s + (size_t)g * 4 * hp;
      adjoint_chunk(row, q * P, L, a.vec_out, gs.x2, r.d2);
      adjoint_chunk(row + hp, q * P, L, a.vec_out, gs.x1, r.d1);
      adjoint_chunk(row + 2 * hp, q * P, L, a.vec_out, gs.v, r.dv);
    }
  }
  __syncthreads();

  // The dkhat partial of this block, once: bin k from its slots in order.
  float2* part = a.part + ((size_t)grp * D + c) * (M + 1);
  for (int k = threadIdx.x; k <= M; k += nthreads) {
    float2 v = make_float2(0.f, 0.f);
    if (k == H) {
      for (int j = 0; j < S / H; ++j) v = cadd(v, acc_h[j]);
    } else if (k < H) {
      for (int j = k; j < S; j += H) v = cadd(v, acc_a[j]);
    } else {
      for (int j = k == M ? 0 : M - k; j < S; j += H) v = cadd(v, acc_b[j]);
    }
    part[k] = v;
  }
  block_sums(sums, red, a.sums + ((size_t)grp * D + c) * 2 * kSums);
}

// N = 16384 and 32768 (pair), 65536 (park): a cluster of two CTAs takes one row at a
// time; CTA r holds half r (bins of parity r). Shared memory: pair, [w half |
// dz half | quarter table | dkhat slots a, b | reduction]; park, [one half |
// quarter table | reduction], with w's spectrum parked in the CTA's scratch
// row and the dkhat partial in the block's partial row. The pair pass takes
// items j, bins k = 2j + r <= H, item j always on the same thread.
template <typename T, bool PARK>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kPairThreads, 1) mixer_bwd_pair(Args a) {
  extern __shared__ float2 s[];
  constexpr int P = Chunk<T>::P;
  constexpr int V = 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int log2h = a.log2n - 2;
  const int H = 1 << log2h;
  const int M = 2 * H;
  const int L = a.L;
  const int D = a.D;
  const int hp = padded(H);
  const int nt = H / V;
  float2* sw = s;                  // half `rank` of w's spectrum, then of z
  float2* sd = PARK ? s : s + hp;  // half `rank` of dz's spectrum, then of dw
  float2* wt = s + (PARK ? 1 : 2) * hp;
  const int items = H / 2 + 1 - rank;
  float2* acc_a = wt + quarter(H);
  float2* acc_b = acc_a + H / 2 + 1;
  float* red = reinterpret_cast<float*>(PARK ? acc_a : acc_b + H / 2 + 1);
  const int cid = blockIdx.x >> 1;
  const int c = cid % D;
  const int grp = cid / D;
  const Gates gs(a, c);
  const float2* kh = a.khat + (size_t)c * (M + 1);
  float2* part = a.part + ((size_t)grp * D + c) * (M + 1);
  float2* park = a.park + (size_t)blockIdx.x * H;
  fft_radix::stage_quarter_table(wt, a.tw, H);
  if (!PARK)
    for (int i = threadIdx.x; i < 2 * (H / 2 + 1); i += blockDim.x) acc_a[i] = make_float2(0.f, 0.f);
  float sums[kSums] = {};
  // E (rank 0) and O (rank 1) of each signal; after the output pass, the slots
  // of the gate cotangents.
  float2* osw = cluster.map_shared_rank(sw, rank ^ 1);
  float2* osd = cluster.map_shared_rank(sd, rank ^ 1);
  float2* ew = rank ? osw : sw;
  float2* ow = rank ? sw : osw;
  float2* ed = rank ? osd : sd;
  float2* od = rank ? sd : osd;
  const int Q = (2 * H + P - 1) / P;  // fill chunks, covering [0, 2H)
  const int Qo = (L + P - 1) / P;     // output chunks, half a CTA
  const int Qh = (Qo + 1) / 2;
  const int qlo = rank * Qh;
  const int qhi = min(Qo, qlo + Qh);
  const int x = PARK ? 0 : threadIdx.x / nt;  // pair: threads of w's half, then dz's

  for (int b = grp; b < a.B; b += a.groups) {
    const Rows<T> r(a, b, c);
    for (int pass = 0; pass < (PARK ? 2 : 1); ++pass) {
      for (int q0 = 0; q0 < Q; q0 += blockDim.x) {
        const int q = q0 + threadIdx.x;
        float2 twm[P / 2];
        chunk_twiddles<P, false>(a.tw, q * P, q < Q && rank ? H : 0, twm);
        const bool fw = !PARK || pass == 0, fd = !PARK || pass == 1;
        fill_chunk(r, q * P, q < Q ? L : 0, a.vec_in, gs, twm, H, fw && !rank ? sw : nullptr,
                   fw && rank ? sw : nullptr, fd && !rank ? sd : nullptr, fd && rank ? sd : nullptr);
      }
      __syncthreads();
      fft_radix::fft<V, false>(x ? sd : sw, log2h, threadIdx.x % nt, true, wt);
      if (PARK && pass == 0) {
        for (int i = threadIdx.x; i < H; i += blockDim.x) park[i] = s[pad(i)];
        __syncthreads();
      }
    }

    for (int j = threadIdx.x; j < items; j += blockDim.x) {
      const int k = 2 * j + rank;
      const int k2 = (M - k) & (M - 1);
      const int ia = k >> 1, ib = k2 >> 1;
      const int pa = pad(ia), pb = pad(ib);
      float2 wa = PARK ? park[ia] : sw[pa], wb = PARK ? park[ib] : sw[pb];
      float2 da = sd[pa], db = sd[pb], ta, tb;
      pair_bwd(wa, wb, da, db, k, M, kh, a.tw, ta, tb);
      const bool two = k != 0 && k2 != k;
      if (PARK) {  // z's spectrum into shared memory, dw's into the park
        s[pa] = wa;
        park[ia] = da;
        if (two) {
          s[pb] = wb;
          park[ib] = db;
        }
        const bool first = b == grp;
        part[k] = first ? ta : cadd(part[k], ta);
        if (M - k != k) part[M - k] = first ? tb : cadd(part[M - k], tb);
      } else {
        sw[pa] = wa;
        sd[pa] = da;
        if (two) {
          sw[pb] = wb;
          sd[pb] = db;
        }
        acc_a[j] = cadd(acc_a[j], ta);
        if (M - k != k) acc_b[j] = cadd(acc_b[j], tb);
      }
    }
    __syncthreads();

    // pair: both inverses, one output pass. park: z first (dx2), then dw
    // (dx1, dv) from the park.
    for (int pass = 0; pass < (PARK ? 2 : 1); ++pass) {
      if (PARK && pass == 1) {
        for (int i = threadIdx.x; i < H; i += blockDim.x) s[pad(i)] = park[i];
        __syncthreads();
      }
      fft_radix::fft<V, true>(x ? sd : sw, log2h, threadIdx.x % nt, true, wt);
      cluster.sync();  // both halves of every inverse done
      const bool do_z = !PARK || pass == 0, do_w = !PARK || pass == 1;
      for (int q0 = qlo; q0 < qlo + Qh; q0 += blockDim.x) {
        const int q = q0 + threadIdx.x;
        const int Lr = q < qhi ? L : 0;
        float2 twc[P / 2];
        chunk_twiddles<P, true>(a.tw, q * P, Lr ? H : 0, twc);
        out_chunk(r, q * P, Lr, a.vec_in, gs, twc, H, do_z ? ew : nullptr, ow, do_w ? ed : nullptr, od, sums, ew,
                  PARK ? ed : ow, PARK ? od : ed);
      }
      cluster.sync();  // every slot written
      for (int q = qlo + threadIdx.x; q < qhi; q += blockDim.x) {
        if (do_z) adjoint_chunk(ew, q * P, L, a.vec_out, gs.x2, r.d2);
        if (do_w) {
          adjoint_chunk(PARK ? ed : ow, q * P, L, a.vec_out, gs.x1, r.d1);
          adjoint_chunk(PARK ? od : ed, q * P, L, a.vec_out, gs.v, r.dv);
        }
      }
      cluster.sync();  // every slot read: the buffers are free
    }
  }

  if (!PARK) {
    for (int j = threadIdx.x; j < items; j += blockDim.x) {
      const int k = 2 * j + rank;
      part[k] = acc_a[j];
      if (M - k != k) part[M - k] = acc_b[j];
    }
  }
  block_sums(sums, red, a.sums + (((size_t)grp * D + c) * 2 + rank) * kSums);
}

// dkhat[c, k] = sum over blocks g = 0 .. groups-1, in that order, of the
// partials; dsh[t, gi D + c] = sum over g, then the block's CTAs in order, of
// their sums gi * 4 + t.
__global__ void mixer_bwd_reduce(const float2* part, const float* sums, float2* dkhat, float* dsh, int D, int M,
                                 int groups, int ctas) {
  const long long nk = (long long)D * (M + 1);
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nk) {
    float2 acc = make_float2(0.f, 0.f);
    for (int g = 0; g < groups; ++g) acc = cadd(acc, part[g * nk + idx]);
    dkhat[idx] = acc;
    return;
  }
  idx -= nk;
  if (idx >= 12ll * D) return;
  const int t = (int)(idx / (3 * D));  // row of dsh: taps 0-2, bias 3
  const int ch = (int)(idx % (3 * D));
  const int gi = ch / D, c = ch % D;
  float acc = 0.f;
  for (int g = 0; g < groups; ++g)
    for (int r = 0; r < ctas; ++r) acc += sums[(((size_t)g * D + c) * 2 + r) * kSums + gi * 4 + t];
  dsh[idx] = acc;
}

Plan plan_for(int B, int D, int log2n) {
  const int log2h = log2n - 2;
  const int H = 1 << log2h;
  Plan p;
  if (log2h >= kPairLog2h) {
    p.kind = log2h >= kParkLog2h ? kPark : kPair;
    p.V = 32;
    p.G = 1;
    p.threads = (p.kind == kPair ? 2 : 1) * H / p.V;  // the CTA's transforms, H / V threads each
    p.ctas = 2;
    const size_t slots = p.kind == kPair ? 2 * (size_t)(H / 2 + 1) : 0;
    p.smem = ((p.kind == kPair ? 2 : 1) * (size_t)padded(H) + quarter(H) + slots) * sizeof(float2);
  } else {
    p.kind = kRows;
    p.V = fft_radix::values_per_thread(H);
    const int nt = H / p.V;
    p.G = 4 * nt >= kMinThreads ? 1 : kMinThreads / (4 * nt);
    p.threads = p.G * 4 * nt;
    p.ctas = 1;
    const int S = H > p.threads ? H : p.threads;
    p.smem = ((size_t)p.G * 4 * padded(H) + quarter(H) + 2 * (size_t)S + S / H) * sizeof(float2);
  }
  p.smem += (size_t)(p.threads / 32) * kSums * sizeof(float);
  int per_sm = (int)(kSmemPerSM / (p.smem + 1024));
  if (per_sm > 2048 / p.threads) per_sm = 2048 / p.threads;
  if (per_sm < 1) per_sm = 1;
  const int sets = (B + p.G - 1) / p.G;
  const int want = (kSMs * per_sm * kWaves + D * p.ctas - 1) / (D * p.ctas);
  p.groups = want < 1 ? 1 : (want > sets ? sets : want);
  return p;
}

// Byte offsets of the scratch pieces: partials, sums, park (256-byte aligned).
struct Scratch {
  size_t sums, park, total;
  Scratch(const Plan& p, int D, int log2n) {
    const size_t M = (size_t)1 << (log2n - 1);
    auto up = [](size_t v) { return (v + 255) / 256 * 256; };
    sums = up((size_t)p.groups * D * (M + 1) * sizeof(float2));
    park = sums + up((size_t)p.groups * D * 2 * kSums * sizeof(float));
    total = park + (p.kind == kPark ? (size_t)p.groups * D * 2 * (M / 2) * sizeof(float2) : 0);
  }
};

// Set a kernel's dynamic shared memory once per device and size: the first
// call of a shape sets it, so a CUDA-graph capture of that shape later sets
// nothing.
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

template <typename T, int V, int THREADS>
cudaError_t launch_rows(const Args& a, const Plan& p, cudaStream_t stream) {
  static SmemAttr attr;
  cudaError_t err = attr.ensure(mixer_bwd_rows<T, V, THREADS>, p.smem);
  if (err != cudaSuccess) return err;
  mixer_bwd_rows<T, V, THREADS><<<p.groups * a.D, THREADS, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool PARK>
cudaError_t launch_pair(const Args& a, const Plan& p, cudaStream_t stream) {
  static SmemAttr attr;
  cudaError_t err = attr.ensure(mixer_bwd_pair<T, PARK>, p.smem);
  if (err != cudaSuccess) return err;
  mixer_bwd_pair<T, PARK><<<2 * p.groups * a.D, p.threads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  if (p.kind == kPark) return launch_pair<T, true>(a, p, stream);
  if (p.kind == kPair) return launch_pair<T, false>(a, p, stream);
  if (p.threads != kMinThreads) return launch_rows<T, 16, 512>(a, p, stream);  // N = 8192
  switch (p.V) {
    case 2: return launch_rows<T, 2, kMinThreads>(a, p, stream);
    case 4: return launch_rows<T, 4, kMinThreads>(a, p, stream);
    case 8: return launch_rows<T, 8, kMinThreads>(a, p, stream);
    default: return launch_rows<T, 16, kMinThreads>(a, p, stream);
  }
}

}  // namespace

extern "C" {

// The layout a call runs: out = {kind (0 rows, 1 pair, 2 park), V, G, threads,
// shared bytes a CTA, groups}.
void mixer_bwd_plan(int B, int D, int log2n, int* out) {
  const Plan p = plan_for(B, D, log2n);
  out[0] = p.kind;
  out[1] = p.V;
  out[2] = p.G;
  out[3] = p.threads;
  out[4] = (int)p.smem;
  out[5] = p.groups;
}

// Bytes of global scratch the call needs.
long long mixer_bwd_scratch_bytes(int B, int D, int log2n) {
  return (long long)Scratch(plan_for(B, D, log2n), D, log2n).total;
}

// dtype: 0 = float32, 1 = bfloat16 (proj, dy and dproj alike). Returns the
// cudaError_t of the launches.
int mixer_bwd(const void* proj, const void* dy, const float* taps, const float* bsh, const void* khat,
              const void* tw, void* scratch, void* dproj, void* dkhat, float* dsh, int B, int D, int L, int log2n,
              int dtype, void* stream) {
  if (B <= 0 || D <= 0 || L <= 0 || log2n < 3 || log2n > kMaxLog2h + 2 || (1 << log2n) < 2 * L || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(B, D, log2n);
  const Scratch sc(p, D, log2n);
  char* base = static_cast<char*>(scratch);
  const int P = dtype == 0 ? Chunk<float>::P : Chunk<__nv_bfloat16>::P;
  const bool whole = L % P == 0;
  Args a{proj, dy, taps, bsh, static_cast<const float2*>(khat), static_cast<const float2*>(tw), dproj,
         reinterpret_cast<float2*>(base), reinterpret_cast<float*>(base + sc.sums),
         reinterpret_cast<float2*>(base + sc.park), B, D, L, log2n, p.G, p.groups,
         whole && ((uintptr_t)proj & 15) == 0 && ((uintptr_t)dy & 15) == 0, whole && ((uintptr_t)dproj & 15) == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? launch<float>(a, p, st) : launch<__nv_bfloat16>(a, p, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)D * ((1 << (log2n - 1)) + 1) + 12ll * D;
  mixer_bwd_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.part, a.sums, static_cast<float2*>(dkhat), dsh, D, 1 << (log2n - 1), p.groups, p.ctas);
  return (int)cudaGetLastError();
}

}  // extern "C"
