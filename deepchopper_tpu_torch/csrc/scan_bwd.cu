// Selective scan of the Mamba mixer (Caduceus), backward: the cotangent walk.
//
// Replaces the Pallas TPU kernel `_scan_bwd_kernel`
// (deepchopper_tpu/ops/pallas_scan.py), driven there by `selective_scan_pallas_bwd`
// after the checkpoint pass `_scan_ckpt_kernel`, whose port is scan_fwd.cu's
// `scan_ckpt`. The C entry `scan_bwd` takes the forward's contract (scan_fwd.cu)
// plus:
//
//   ckpt (B, nl, N, Din) float32, nl = ceil(L / 32): ckpt[b, c] is the state
//        on entering tile c (t in [32c, 32c + 32)) in the scan's direction of
//        walk (scan_ckpt's output);
//   from ckpt and dy (B, L, Din): du, ddelta (B, L, Din), dBp, dCp (B, L, N),
//        dA (Din, N), dD (Din,), all float32.
//
// Per step of the walk (t in walk order s, a_s = exp(delta_s A), q_s = a_s h_{s-1},
// so h_s = q_s + delta_s u_s Bp_s):
//   g_s  = Cp_s dy_s + a_{s+1} g_{s+1}            cotangent of h_s
//   ddelta_s = sum_n g_s A q_s + u_s sum_n g_s Bp_s,  du_s = delta_s sum_n g_s Bp_s + D dy_s
//   dBp_s = sum_d g_s delta_s u_s,  dCp_s = sum_d h_s dy_s
//   dA += g_s q_s delta_s,  dD += dy_s u_s.
//
// Design. The TPU kernels got three things from their sequential grid that
// Hopper blocks do not have; each is replaced as follows.
//  (i) The states of a tile. The block (one batch row, DT = 256 / N channels,
//      one thread per (channel, state)) reloads the tile's entry state from
//      ckpt and recomputes the tile's 32 steps (pass 1): one exp a step, as
//      ex2.approx of delta A log2(e), whose a_s and delta_s q_s stay in 64
//      registers (fully unrolled loops) for the cotangent walk (pass 2), which
//      makes no exp.
//  (ii) The cotangent carry g crosses tiles in a register of the same thread:
//      the block walks its tiles against the scan's direction. A step of pass
//      2 is g += Cp dy, one store of g, the thread's own dA term and g *= a:
//      no shuffle and no lane doing another's work. Pass 1 stores q.
//  (iii) The sums. After the walk, over the block's buffers of g and q
//      ([step][256], XOR-swizzled so that the walk's stores and both sums
//      below hit 32 distinct banks a warp): each (step, channel) sums its
//      states in order into ddelta and du, written straight to (B, L, Din),
//      and leaves g delta u and h dy (h = q + delta u Bp, the walk's own
//      rounding) in place of g and q; each (step, state) then sums those over
//      the channels in order into one dBp / dCp partial per channel tile. dA
//      and dD sum over every batch row: each block writes its row's sums (dD
//      over its step classes, in order). A second kernel adds the partials
//      in a fixed order. No atomics: two calls give the same bits.
//  Sums over a whole row (dA, dD) are taken per tile and then across tiles,
//  which keeps their float32 rounding near sqrt(L / 32) tiles' worth.
//  Inputs move by cp.async in double-buffered tiles, in walk order (slot j is
//  the j-th step the forward took in the tile): u, delta, dy as 16-byte
//  chunks of rows where the rows are 16-byte aligned, else 4-byte copies; Bp,
//  Cp and the entry state as 4-byte copies. The next tile's copy is in flight
//  while this one is walked and summed; three barriers a tile.
//
// Shared memory a block: two tile buffers of 3 * 32 * DT (u, delta, dy) + 2 *
// 32 * N (Bp, Cp) + DT * (N + 1) (entry state) floats, and the g and q
// buffers, 2 * 32 * 256: 22048 floats (86.1 KB) at N = 16, 24128 (94.25 KB) at
// N = 8. So two blocks an SM (of 228 KB), and __launch_bounds__ holds a
// thread to the 128 registers that two blocks allow.
//
// What bounds it on an H100. Bytes: u, delta, dy read and du, ddelta written
// (20 B per token-channel) plus Bp, Cp, dBp, dCp and ckpt: 10.5 KB a token at
// Din = 512, 0.42 ms per 2^17 tokens at 3.35 TB/s. Operations: one exp per
// token-channel-state on the special-function units, as the forward (0.26
// ms per 2^17 tokens). The block's shared memory traffic is larger: a warp
// makes seven accesses a step of the walk, and seven for each 32 (step,
// channel, state) of the sums after it; at one such access a clock per SM,
// about 1.8 ms per 2^17 tokens at N = 16. It also writes and reads 2 * Din / DT partials of dBp and dCp,
// about 0.54 GB at 2^17 tokens.
#include <cstdint>

#include "scan_common.cuh"

namespace scan {

// Floats of one staged tile: u, delta, dy rows; Bp, Cp rows; the entry state
// as [channel][state], rows of N + 1.
template <int N>
__host__ __device__ constexpr int bwd_tile_floats() {
  return 3 * kChunk * channels_per_block(N) + 2 * kChunk * N + channels_per_block(N) * (N + 1);
}

template <int N>
__host__ __device__ constexpr size_t bwd_smem_floats() {
  return 2 * bwd_tile_floats<N>() + 2 * kChunk * kThreads;  // two tiles; the g and q buffers
}
// Two blocks an SM: 228 KB, less 1 KB the runtime keeps a block.
static_assert(2 * (bwd_smem_floats<8>() * sizeof(float) + 1024) <= 228 * 1024, "two blocks an SM at N = 8");
static_assert(2 * (bwd_smem_floats<16>() * sizeof(float) + 1024) <= 228 * 1024, "two blocks an SM at N = 16");

// Position of (channel dl, state n) among the 256 floats of step s in the g
// and q buffers. The XOR swizzle puts each warp's accesses on 32 distinct
// banks: the walk's stores (one step; channels x states), the sums over
// states (steps x channels) and over channels (steps x states).
template <int N>
__device__ __forceinline__ int swz(int s, int dl, int n) {
  static_assert(N == 8 || N == 16, "N in {8, 16}");
  if constexpr (N == 16) {
    return ((dl ^ (s & 1)) << 4) | (n ^ (dl & 15));
  } else {
    return ((dl ^ (((dl >> 3) ^ s) & 3)) << 3) | (n ^ (dl & 7));
  }
}

struct BwdArgs {
  const float* u;
  const float* delta;
  const float* A;
  const float* Bp;
  const float* Cp;
  const float* D;
  const float* dy;
  const float* ckpt;
  float* du;
  float* ddelta;
  float* part_db;  // (Din / DT, B, L, N)
  float* part_dc;  // (Din / DT, B, L, N)
  float* part_da;  // (B, Din, N)
  float* part_dd;  // (B, Din)
  long long b_sb, b_st, c_sb, c_st;
  int batch, L, din, reverse, vec16;
};

// Copy tile c of the block's rows into one tile buffer, step slot j holding
// the j-th step the forward took in the tile. Issues one cp.async group.
template <int N>
__device__ __forceinline__ void stage_tile(float* buf, const BwdArgs& p, int b, int d0, int c, int nl) {
  constexpr int DT = channels_per_block(N);
  const int t_lo = c * kChunk, len = min(kChunk, p.L - t_lo);
  float* su = buf;
  float* sd = su + kChunk * DT;
  float* sy = sd + kChunk * DT;
  float* sb = sy + kChunk * DT;
  float* sc = sb + kChunk * N;
  float* sh = sc + kChunk * N;
  const long long row0 = (long long)b * p.L + t_lo;
  const int tid = threadIdx.x;
  if (p.vec16) {
    constexpr int Q = DT / 4;
    for (int k = tid; k < len * Q; k += kThreads) {
      const int j = k / Q, c4 = (k - j * Q) * 4;
      const long long g = (row0 + (p.reverse ? len - 1 - j : j)) * p.din + d0 + c4;
      cp_async16(su + j * DT + c4, p.u + g);
      cp_async16(sd + j * DT + c4, p.delta + g);
      cp_async16(sy + j * DT + c4, p.dy + g);
    }
  } else {
    for (int k = tid; k < len * DT; k += kThreads) {
      const int j = k / DT, dl = k - j * DT;
      const long long g = (row0 + (p.reverse ? len - 1 - j : j)) * p.din + d0 + dl;
      cp_async4(su + j * DT + dl, p.u + g);
      cp_async4(sd + j * DT + dl, p.delta + g);
      cp_async4(sy + j * DT + dl, p.dy + g);
    }
  }
  for (int k = tid; k < len * N; k += kThreads) {
    const int j = k / N, n = k - j * N;
    const long long t = t_lo + (p.reverse ? len - 1 - j : j);
    cp_async4(sb + k, p.Bp + b * p.b_sb + t * p.b_st + n);
    cp_async4(sc + k, p.Cp + b * p.c_sb + t * p.c_st + n);
  }
  // ckpt[b, c] is [state][channel]: read along channels, kept as [channel][state].
  const int nn = tid / DT, dd = tid - nn * DT;  // N * DT == kThreads
  cp_async4(sh + dd * (N + 1) + nn, p.ckpt + ((long long)b * nl + c) * N * p.din + (long long)nn * p.din + d0 + dd);
  cp_async_commit();
}

// Passes 1 and 2 over one tile for thread (channel dl, state n), from the
// entry state h; g carries the cotangent in and out. Stores q (pass 1) and g
// (pass 2) of every step; returns the tile's dA term sum. kFull: all kChunk
// steps, else the first len (a ragged last tile).
template <int N, bool kFull>
__device__ __forceinline__ float walk_tile(float& g, float h, float a2, const int (&off)[4], int dl, int n, int len,
                                           const float* su, const float* sd, const float* sy, const float* sb,
                                           const float* sc, float* s_g, float* s_q) {
  constexpr int DT = channels_per_block(N);
  float as[kChunk], ws[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (kFull || j < len) {
      const float dt = sd[j * DT + dl];
      const float a = exp2_approx(dt * a2);
      const float q = a * h;
      h = fmaf(dt * su[j * DT + dl], sb[j * N + n], q);
      s_q[j * kThreads + off[j & 3]] = q;
      as[j] = a;
      ws[j] = dt * q;
    }
  }
  float da = 0.f;
#pragma unroll
  for (int j = kChunk - 1; j >= 0; --j) {
    if (kFull || j < len) {
      g = fmaf(sc[j * N + n], sy[j * DT + dl], g);
      s_g[j * kThreads + off[j & 3]] = g;
      da = fmaf(g, ws[j], da);
      g = as[j] * g;  // the carry into the step before
    }
  }
  return da;
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2) scan_bwd_kernel(const BwdArgs p) {
  constexpr int DT = channels_per_block(N), TF = bwd_tile_floats<N>();
  extern __shared__ __align__(16) float smem[];
  float* s_g = smem + 2 * TF;            // [step][swz]: g, then g delta u
  float* s_q = s_g + kChunk * kThreads;  // [step][swz]: q, then h dy

  const int tiles = p.din / DT;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int d0 = tile * DT;
  const int tid = threadIdx.x;
  // The walk: thread = (channel dl, state n).
  const int dl = tid / N, n = tid - dl * N;
  const float a2 = p.A[(d0 + dl) * N + n] * kLog2e;
  int off[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) off[r] = swz<N>(r, dl, n);
  // The sums over states: thread = (step class tid / DT, channel ca).
  const int ca = tid % DT;
  float arow[N];
#pragma unroll
  for (int k = 0; k < N; ++k) arow[k] = p.A[(d0 + ca) * N + k];
  const float dsk = p.D[d0 + ca];
  const long long base = (long long)b * p.L * p.din;
  const int nl = (p.L + kChunk - 1) / kChunk;
  // Tiles against the forward walk: the last tile of the walk first.
  auto tile_of = [&](int k) { return p.reverse ? k : nl - 1 - k; };

  float g = 0.f, da_sum = 0.f, dd_sum = 0.f;
  stage_tile<N>(smem, p, b, d0, tile_of(0), nl);
  for (int k = 0; k < nl; ++k) {
    const int c = tile_of(k);
    const int t_lo = c * kChunk, len = min(kChunk, p.L - t_lo);
    const float* su = smem + (k & 1) * TF;
    const float* sd = su + kChunk * DT;
    const float* sy = sd + kChunk * DT;
    const float* sb = sy + kChunk * DT;
    const float* sc = sb + kChunk * N;
    const float* sh = sc + kChunk * N;
    cp_async_wait_all();
    // Tile k has landed for every thread, and every thread is done with tile
    // k - 1, whose buffer the next copy overwrites, and with the g and q buffers.
    __syncthreads();
    if (k + 1 < nl) stage_tile<N>(smem + ((k + 1) & 1) * TF, p, b, d0, tile_of(k + 1), nl);

    const float h_in = sh[dl * (N + 1) + n];
    da_sum += len == kChunk ? walk_tile<N, true>(g, h_in, a2, off, dl, n, len, su, sd, sy, sb, sc, s_g, s_q)
                            : walk_tile<N, false>(g, h_in, a2, off, dl, n, len, su, sd, sy, sb, sc, s_g, s_q);
    __syncthreads();

    // Sums over states, (step, channel) each, states in order.
    float dd_tile = 0.f;
    for (int kk = tid; kk < len * DT; kk += kThreads) {
      const int s = kk / DT;
      float* gs = s_g + s * kThreads;
      float* qs = s_q + s * kThreads;
      const float dt = sd[s * DT + ca], ut = su[s * DT + ca], dyt = sy[s * DT + ca];
      const float bu = dt * ut;
      float vb = 0.f, va = 0.f;
#pragma unroll
      for (int nn = 0; nn < N; ++nn) {
        const int o = swz<N>(s, ca, nn);
        const float gv = gs[o], qv = qs[o], bp = sb[s * N + nn];
        vb = fmaf(gv, bp, vb);
        va = fmaf(arow[nn], gv * qv, va);
        gs[o] = gv * bu;                 // for dBp
        qs[o] = fmaf(bu, bp, qv) * dyt;  // h dy, for dCp
      }
      const long long o = base + (long long)(t_lo + (p.reverse ? len - 1 - s : s)) * p.din + d0 + ca;
      p.du[o] = fmaf(vb, dt, dsk * dyt);
      p.ddelta[o] = fmaf(vb, ut, va);
      dd_tile = fmaf(dyt, ut, dd_tile);
    }
    dd_sum += dd_tile;
    __syncthreads();

    // Sums over channels, (step, state) each, channels in order: this tile's
    // dBp and dCp partials.
    // Unrolled whole at N = 16; 8 at a time at N = 8 (32 channels), which
    // keeps that instance within the 128 registers with no spills.
    constexpr int kSumUnroll = N == 16 ? DT : 8;
    const long long part = (((long long)tile * p.batch + b) * p.L + t_lo) * N;
    for (int kk = tid; kk < len * N; kk += kThreads) {
      const int s = kk / N, nn = kk - s * N;
      const float* gs = s_g + s * kThreads;
      const float* qs = s_q + s * kThreads;
      float sbv = 0.f, scv = 0.f;
#pragma unroll kSumUnroll
      for (int dd = 0; dd < DT; ++dd) {
        const int o = swz<N>(s, dd, nn);
        sbv += gs[o];
        scv += qs[o];
      }
      const long long o = part + (long long)(p.reverse ? len - 1 - s : s) * N + nn;
      p.part_db[o] = sbv;
      p.part_dc[o] = scv;
    }
  }
  p.part_da[((long long)b * p.din + d0 + dl) * N + n] = da_sum;
  // dD: each channel's step classes, in order.
  __syncthreads();
  s_g[tid] = dd_sum;
  __syncthreads();
  if (tid < DT) {
    float sum = 0.f;
    for (int r = 0; r < kThreads / DT; ++r) sum += s_g[r * DT + tid];
    p.part_dd[(long long)b * p.din + d0 + tid] = sum;
  }
}

// dBp, dCp = sums of the channel-tile partials; dA, dD = sums of the batch-row
// partials; each in a fixed order.
__global__ void scan_bwd_reduce(const float* __restrict__ part_db, const float* __restrict__ part_dc,
                                const float* __restrict__ part_da, const float* __restrict__ part_dd,
                                float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ da,
                                float* __restrict__ dd, int tiles, int batch, int L, int din, int n) {
  const long long n_bc = (long long)batch * L * n;
  const long long n_a = (long long)din * n;
  const long long total = n_bc + n_a + din;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    if (idx < n_bc) {
      float sb = 0.f, sc = 0.f;
      for (int t = 0; t < tiles; ++t) {
        sb += part_db[t * n_bc + idx];
        sc += part_dc[t * n_bc + idx];
      }
      dbp[idx] = sb;
      dcp[idx] = sc;
    } else if (idx < n_bc + n_a) {
      const long long j = idx - n_bc;
      float s = 0.f;
      for (int r = 0; r < batch; ++r) s += part_da[r * n_a + j];
      da[j] = s;
    } else {
      const long long j = idx - n_bc - n_a;
      float s = 0.f;
      for (int r = 0; r < batch; ++r) s += part_dd[(long long)r * din + j];
      dd[j] = s;
    }
  }
}

template <int N>
static int launch_bwd(const float* u, const float* delta, const float* A, const float* Bp, const float* Cp,
                      const float* D, const float* dy, const float* ckpt, float* scratch, float* du, float* ddelta,
                      float* dbp, float* dcp, float* da, float* dd, int batch, int L, int din, long long b_sb,
                      long long b_st, long long c_sb, long long c_st, int reverse, cudaStream_t stream) {
  const int tiles = din / channels_per_block(N);
  const size_t smem = bwd_smem_floats<N>() * sizeof(float);
  // All of the SM's shared memory to the blocks: two fit.
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<N>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_bc = (long long)batch * L * N;
  BwdArgs p;
  p.u = u;
  p.delta = delta;
  p.A = A;
  p.Bp = Bp;
  p.Cp = Cp;
  p.D = D;
  p.dy = dy;
  p.ckpt = ckpt;
  p.du = du;
  p.ddelta = ddelta;
  p.part_db = scratch;
  p.part_dc = p.part_db + tiles * n_bc;
  p.part_da = p.part_dc + tiles * n_bc;
  p.part_dd = p.part_da + (long long)batch * din * N;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.batch = batch;
  p.L = L;
  p.din = din;
  p.reverse = reverse;
  p.vec16 = ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(delta) | reinterpret_cast<uintptr_t>(dy)) &
             15) == 0;
  scan_bwd_kernel<N><<<batch * tiles, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = n_bc + (long long)din * N + din;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  scan_bwd_reduce<<<blocks, 256, 0, stream>>>(p.part_db, p.part_dc, p.part_da, p.part_dd, dbp, dcp, da, dd, tiles,
                                              batch, L, din, N);
  return (int)cudaGetLastError();
}

}  // namespace scan

// Floats of scratch scan_bwd needs: the dBp and dCp partials of every channel
// tile, and the dA and dD partials of every batch row.
extern "C" long long scan_bwd_scratch_floats(int batch, int L, int din, int n) {
  if (n <= 0) return 0;
  const long long tiles = din / scan::channels_per_block(n);
  return 2 * tiles * batch * (long long)L * n + (long long)batch * din * n + (long long)batch * din;
}

extern "C" int scan_bwd(const float* u, const float* delta, const float* A, const float* Bp, const float* Cp,
                        const float* D, const float* dy, const float* ckpt, float* scratch, float* du, float* ddelta,
                        float* dbp, float* dcp, float* da, float* dd, int batch, int L, int din, int n,
                        long long b_sb, long long b_st, long long c_sb, long long c_st, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!scan::valid_shape(batch, L, din, n)) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 8:
      return scan::launch_bwd<8>(u, delta, A, Bp, Cp, D, dy, ckpt, scratch, du, ddelta, dbp, dcp, da, dd, batch, L, din,
                                 b_sb, b_st, c_sb, c_st, reverse, s);
    case 16:
      return scan::launch_bwd<16>(u, delta, A, Bp, Cp, D, dy, ckpt, scratch, du, ddelta, dbp, dcp, da, dd, batch, L, din,
                                  b_sb, b_st, c_sb, c_st, reverse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
