// Selective scan of the Mamba mixer (Caduceus), forward, and the backward's
// checkpoint pass, which walks the same recurrence.
//
// Replaces the Pallas TPU kernels `_scan_kernel` (deepchopper_tpu/ops/pallas_scan.py),
// entered there through `selective_scan_pallas`, and `_scan_ckpt_kernel`, the
// first pass of `selective_scan_pallas_bwd`. Same contracts:
//
//   u, delta (B, L, Din) float32, contiguous
//   A        (Din, N)    float32
//   Bp, Cp   (B, L, N)   float32, unit stride along N, strides (sb, st) otherwise
//   D        (Din,)      float32
//   scan_fwd:  y (B, L, Din) float32:  h[t] = exp(delta[t] A) h[t-1] + delta[t] u[t] Bp[t],
//                                      y[t] = sum_n Cp[t, n] h[t][n] + D u[t],  h = 0 before the walk.
//   scan_ckpt: ckpt (B, nl, N, Din) float32, nl = ceil(L / 32): ckpt[b, c] is the
//              state on entering chunk c (t in [32c, 32c + 32)) in the walk's
//              direction, so ckpt[b, 0] of a forward walk and ckpt[b, nl - 1]
//              of a reverse walk are zero.
//   reverse != 0 walks t = L-1 .. 0 (flip(scan(flip(.))) without the flips).
//
// What bounds them on an H100. Operations: Din * N exps a token on the
// special-function units, 16 a clock per SM: 0.257 ms per 2^17 tokens at Din
// 512, N 16 and 1.98 GHz. Bytes just below: for y, u, delta read and y written
// once (12 B a token-channel) plus Bp, Cp, 0.25 ms per 2^17 tokens at 3.35
// TB/s; for the checkpoints, u and delta (8 B) plus N / 32 states (2 B at N =
// 16) and Bp, 0.17 ms.
//
// Design. The TPU kernels walk L-chunks in grid order and carry the
// (bt, N, Din) state in VMEM scratch. Here one thread owns one channel of one
// batch row: its N states h[n] and A[n] log2(e) live in registers, so a step
// is, per state, one FMUL and one ex2.approx (exp(dt A) = exp2(dt A log2 e)),
// an FMUL and an FFMA for h and an FFMA for y's sum over states, all inside
// the thread: no shuffles and no lane doing another's work. A block takes
// `channels` consecutive channels of one batch row. Its inputs move in tiles
// of `tile` steps staged in shared memory by cp.async (u and delta as whole
// 16-byte chunks of rows, Bp and, for y, Cp as N floats a step, read back as
// float4 broadcasts), double buffered: the next tile's copy is in flight while
// this one is walked, one barrier a tile. y leaves straight from registers, a
// coalesced row of the block's channels a step. The checkpoint walk is the
// same walk with other stores: no Cp and no y; where the walk enters a
// 32-step chunk (tiles divide the chunk and segments start on chunk
// boundaries, so a tile lies in one chunk), each thread writes its N states
// straight from registers, a coalesced row of the block's channels a state.
//
// Where batch x Din / channels blocks cannot fill the card (the wide buckets:
// 16 blocks at B = 4, L = 32768), the wrapper's plan (ops/scan.py
// `scan_fwd_plan`, `scan_ckpt_plan`) splits L into `segments` runs of
// `seg_len` steps, a whole number of tiles each (of 32-step chunks for the
// checkpoints), and there are two launches:
//   1. scan_fwd_kernel<N, Walk::kEnd> walks every segment but the last in walk
//      order from h = 0 and writes its end state h_end and its sum of dt per
//      channel to the scratch;
//   2. scan_fwd_kernel<N, Walk::kY> (or Walk::kCkpt) folds, in each (row,
//      channel tile, segment) block, the segments before its own in walk
//      order, first walked first: h <- exp2(A log2(e) sum(dt)) h + h_end, then
//      walks its segment from that state and writes y (or the checkpoints of
//      the chunks it enters).
// Segmenting doubles the exps of that path and puts `segments` times more
// blocks in flight. There are no atomics: every result is bitwise repeatable.
// Reverse walks the segments, the tiles in each and the steps in each tile
// from the end; a ragged last tile or segment simply has fewer steps.
#include <cstdint>

#include "scan_common.cuh"

namespace scan {

constexpr int kFwdMaxChannels = 128;  // threads a block: one channel each
constexpr int kFwdMaxTile = 64;
constexpr int kSmemLimit = 227 * 1024;

// What a walk of one segment writes.
enum class Walk {
  kEnd,   // from h = 0: the segment's end state and sum of dt, to the scratch
  kY,     // from the folded entry state: y
  kCkpt,  // from the folded entry state: the state on entering each chunk
};

struct FwdArgs {
  const float* u;
  const float* delta;
  const float* A;
  const float* Bp;
  const float* Cp;
  const float* D;
  float* y;
  float* ckpt;    // (B, nl, N, Din)
  float* h_end;   // (B, segments, N, Din): end state of each segment walked from 0
  float* dt_sum;  // (B, segments, Din): sum of dt over each segment
  long long b_sb, b_st, c_sb, c_st;
  int L, din, channels, tile, segments, seg_len, reverse, vec16;
};

// Floats of one staged tile: u, delta (tile x channels each), Bp, Cp (tile x N each).
__host__ __device__ constexpr int tile_floats(int tile, int channels, int n) { return tile * (2 * channels + 2 * n); }

// Copy steps [t_lo, t_lo + len) of the block's rows into one tile buffer:
// u and delta rows (channels floats each, 16-byte chunks when aligned), Bp
// and, for the y walk, Cp (N floats a step). Issues one cp.async group.
template <int N, bool kY>
__device__ __forceinline__ void stage_tile(float* buf, const FwdArgs& p, long long row0, int b, int d0, int t_lo,
                                           int len) {
  const int cb = p.channels;
  float* su = buf;
  float* sd = su + p.tile * cb;
  float* sb = sd + p.tile * cb;
  float* sc = sb + p.tile * N;
  const int tid = threadIdx.x;
  if (p.vec16) {
    const int q = cb / 4;
    for (int k = tid; k < len * q; k += cb) {
      const int i = k / q, c4 = (k - i * q) * 4;
      const long long g = (row0 + t_lo + i) * p.din + d0 + c4;
      cp_async16(su + i * cb + c4, p.u + g);
      cp_async16(sd + i * cb + c4, p.delta + g);
    }
  } else {
    for (int k = tid; k < len * cb; k += cb) {
      const int i = k / cb, c = k - i * cb;
      const long long g = (row0 + t_lo + i) * p.din + d0 + c;
      cp_async4(su + k, p.u + g);
      cp_async4(sd + k, p.delta + g);
    }
  }
  for (int k = tid; k < len * N; k += cb) {
    const int i = k / N, n = k - i * N;
    cp_async4(sb + k, p.Bp + b * p.b_sb + (long long)(t_lo + i) * p.b_st + n);
    if (kY) cp_async4(sc + k, p.Cp + b * p.c_sb + (long long)(t_lo + i) * p.c_st + n);
  }
  cp_async_commit();
}

// The entry state of segment s: the end states of the segments walked before
// it, first walked first, each carried through the later ones'
// exp2(a2 sum(dt)).
template <int N>
__device__ __forceinline__ void fold_entry(float (&h)[N], const float (&a2)[N], const FwdArgs& p, int b, int s,
                                           int d) {
  const int count = p.reverse ? p.segments - 1 - s : s;
  // The loads of an entry do not wait on h: unrolled, several are in flight.
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const int k = p.reverse ? p.segments - 1 - j : j;
    const long long e = (long long)b * p.segments + k;
    const float g = p.dt_sum[e * p.din + d];
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = fmaf(exp2_approx(a2[n] * g), h[n], p.h_end[(e * N + n) * p.din + d]);
  }
}

// One step of the N states: h <- exp2(dt a2) h + (dt u) Bp; for the y walk
// also y += Cp h, states in order.
template <int N, bool kY>
__device__ __forceinline__ float walk_step(float (&h)[N], const float (&a2)[N], float dt, float bu,
                                           const float* sb, const float* sc) {
  const float4* bq = reinterpret_cast<const float4*>(sb);
  const float4* cq = reinterpret_cast<const float4*>(sc);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 bv = bq[q];
    h[4 * q + 0] = fmaf(exp2_approx(dt * a2[4 * q + 0]), h[4 * q + 0], bu * bv.x);
    h[4 * q + 1] = fmaf(exp2_approx(dt * a2[4 * q + 1]), h[4 * q + 1], bu * bv.y);
    h[4 * q + 2] = fmaf(exp2_approx(dt * a2[4 * q + 2]), h[4 * q + 2], bu * bv.z);
    h[4 * q + 3] = fmaf(exp2_approx(dt * a2[4 * q + 3]), h[4 * q + 3], bu * bv.w);
    if (kY) {
      const float4 cv = cq[q];
      acc = fmaf(cv.x, h[4 * q + 0], acc);
      acc = fmaf(cv.y, h[4 * q + 1], acc);
      acc = fmaf(cv.z, h[4 * q + 2], acc);
      acc = fmaf(cv.w, h[4 * q + 3], acc);
    }
  }
  return acc;
}

// kEnd: walk a segment from h = 0 and write its end state and sum of dt.
// Otherwise: fold the segment's entry state, walk it and write y or the
// checkpoints.
template <int N, Walk kWalk>
__global__ void __launch_bounds__(kFwdMaxChannels, 4) scan_fwd_kernel(const FwdArgs p) {
  constexpr bool kEnd = kWalk == Walk::kEnd, kY = kWalk == Walk::kY;
  extern __shared__ __align__(16) float smem[];
  const int cb = p.channels;
  const int ctiles = p.din / cb;
  const int walked = kEnd ? p.segments - 1 : p.segments;
  const int sw = blockIdx.x % walked;
  const int ct = (blockIdx.x / walked) % ctiles;
  const int b = blockIdx.x / (walked * ctiles);
  const int s = kEnd && p.reverse ? sw + 1 : sw;  // pass 1 skips the last segment of the walk
  const int tid = threadIdx.x;
  const int d0 = ct * cb, d = d0 + tid;
  const int lo = s * p.seg_len, hi = min(p.L, lo + p.seg_len);
  const long long row0 = (long long)b * p.L;

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = p.A[d * N + n] * kLog2e;
    h[n] = 0.f;
  }
  if (!kEnd) fold_entry<N>(h, a2, p, b, s, d);
  const float dsk = kY ? p.D[d] : 0.f;

  const int per_buf = tile_floats(p.tile, cb, N);
  const int nt = (hi - lo + p.tile - 1) / p.tile;
  auto tile_lo = [&](int k) { return lo + (p.reverse ? nt - 1 - k : k) * p.tile; };
  stage_tile<N, kY>(smem, p, row0, b, d0, tile_lo(0), min(p.tile, hi - tile_lo(0)));
  float dsum = 0.f;
  int chunk = -1;  // kCkpt: the chunk the walk is in
  for (int k = 0; k < nt; ++k) {
    const int t_lo = tile_lo(k), len = min(p.tile, hi - t_lo);
    if constexpr (kWalk == Walk::kCkpt) {
      if (t_lo / kChunk != chunk) {
        // The walk enters a chunk with this tile: its entry state, one
        // coalesced row of the block's channels a state.
        chunk = t_lo / kChunk;
        const long long o = ((long long)b * ((p.L + kChunk - 1) / kChunk) + chunk) * N * p.din + d;
#pragma unroll
        for (int n = 0; n < N; ++n) p.ckpt[o + (long long)n * p.din] = h[n];
      }
    }
    float* buf = smem + (k & 1) * per_buf;
    cp_async_wait_all();
    // Tile k has landed for every thread, and every thread is done with tile
    // k - 1, whose buffer the next copy overwrites.
    __syncthreads();
    if (k + 1 < nt) {
      const int n_lo = tile_lo(k + 1);
      stage_tile<N, kY>(smem + ((k + 1) & 1) * per_buf, p, row0, b, d0, n_lo, min(p.tile, hi - n_lo));
    }
    const float* su = buf;
    const float* sd = su + p.tile * cb;
    const float* sb = sd + p.tile * cb;
    const float* sc = sb + p.tile * N;
    for (int j = 0; j < len; ++j) {
      const int i = p.reverse ? len - 1 - j : j;
      const float dt = sd[i * cb + tid], ut = su[i * cb + tid];
      const float acc = walk_step<N, kY>(h, a2, dt, dt * ut, sb + i * N, sc + i * N);
      if constexpr (kEnd) dsum += dt;
      if constexpr (kY) p.y[(row0 + t_lo + i) * p.din + d] = fmaf(dsk, ut, acc);
    }
  }
  if (kEnd) {
    const long long e = (long long)b * p.segments + s;
#pragma unroll
    for (int n = 0; n < N; ++n) p.h_end[(e * N + n) * p.din + d] = h[n];
    p.dt_sum[e * p.din + d] = dsum;
  }
}

template <typename Kernel>
static cudaError_t launch_one(Kernel kernel, int blocks, const FwdArgs& p, size_t smem, cudaStream_t stream) {
  // All of the SM's shared memory to the blocks: the tiles decide how many fit.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, p.channels, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N, Walk kOut>
static int launch(const FwdArgs& p, int batch, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)tile_floats(p.tile, p.channels, N);
  const int row_blocks = batch * (p.din / p.channels);
  if (p.segments > 1) {
    const cudaError_t err =
        launch_one(scan_fwd_kernel<N, Walk::kEnd>, row_blocks * (p.segments - 1), p, smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_one(scan_fwd_kernel<N, kOut>, row_blocks * p.segments, p, smem, stream);
}

// The plan the kernels take (ops/scan.py `scan_fwd_plan` and `scan_ckpt_plan`
// make it). The checkpoint walk's segments start on chunk boundaries and its
// tiles divide the chunk, so that no tile lies in two chunks.
inline bool valid_plan(int L, int din, int n, int channels, int tile, int segments, int seg_len, bool ckpt) {
  return channels > 0 && channels <= kFwdMaxChannels && channels % 16 == 0 && din % channels == 0 && tile > 0 &&
         tile <= kFwdMaxTile && seg_len > 0 && seg_len % tile == 0 && segments == (L + seg_len - 1) / seg_len &&
         (!ckpt || (seg_len % kChunk == 0 && kChunk % tile == 0)) &&
         2 * sizeof(float) * (size_t)tile_floats(tile, channels, n) <= (size_t)kSmemLimit;
}

// What both entries share: the checks, and the arguments but for Cp, D and
// the output.
static int make_args(FwdArgs& p, const float* u, const float* delta, const float* A, const float* Bp,
                     float* scratch, int batch, int L, int din, int n, long long b_sb, long long b_st, int reverse,
                     int channels, int tile, int segments, int seg_len, bool ckpt) {
  if (!valid_shape(batch, L, din, n) || !valid_plan(L, din, n, channels, tile, segments, seg_len, ckpt) ||
      (segments > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  p = FwdArgs{};
  p.u = u;
  p.delta = delta;
  p.A = A;
  p.Bp = Bp;
  p.h_end = scratch;
  p.dt_sum = scratch == nullptr ? nullptr : scratch + (long long)batch * segments * n * din;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.L = L;
  p.din = din;
  p.channels = channels;
  p.tile = tile;
  p.segments = segments;
  p.seg_len = seg_len;
  p.reverse = reverse;
  p.vec16 = ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(delta)) & 15) == 0;
  return 0;
}

template <Walk kOut>
static int launch_n(const FwdArgs& p, int batch, int n, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<8, kOut>(p, batch, stream);
    case 16: return launch<16, kOut>(p, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace scan

// `scratch`: (B, segments, Din, N + 1) floats when segments > 1 (the end
// states, then the sums of dt), else unused.
extern "C" int scan_fwd(const float* u, const float* delta, const float* A, const float* Bp, const float* Cp,
                        const float* D, float* y, float* scratch, int batch, int L, int din, int n, long long b_sb,
                        long long b_st, long long c_sb, long long c_st, int reverse, int channels, int tile,
                        int segments, int seg_len, void* stream) {
  scan::FwdArgs p;
  const int err = scan::make_args(p, u, delta, A, Bp, scratch, batch, L, din, n, b_sb, b_st, reverse, channels, tile,
                                  segments, seg_len, false);
  if (err != 0) return err;
  p.Cp = Cp;
  p.D = D;
  p.y = y;
  p.c_sb = c_sb;
  p.c_st = c_st;
  return scan::launch_n<scan::Walk::kY>(p, batch, n, static_cast<cudaStream_t>(stream));
}

// `scratch` as scan_fwd's.
extern "C" int scan_ckpt(const float* u, const float* delta, const float* A, const float* Bp, float* ckpt,
                         float* scratch, int batch, int L, int din, int n, long long b_sb, long long b_st, int reverse,
                         int channels, int tile, int segments, int seg_len, void* stream) {
  scan::FwdArgs p;
  const int err = scan::make_args(p, u, delta, A, Bp, scratch, batch, L, din, n, b_sb, b_st, reverse, channels, tile,
                                  segments, seg_len, true);
  if (err != 0) return err;
  p.ckpt = ckpt;
  return scan::launch_n<scan::Walk::kCkpt>(p, batch, n, static_cast<cudaStream_t>(stream));
}
