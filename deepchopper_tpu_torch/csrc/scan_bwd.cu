// Selective scan of the Mamba mixer (Caduceus), backward: the checkpoint pass
// and the cotangent walk.
//
// Replaces the Pallas TPU kernels `_scan_ckpt_kernel` and `_scan_bwd_kernel`
// (deepchopper_tpu/ops/pallas_scan.py), driven there by `selective_scan_pallas_bwd`.
// Two C entry points, the forward's contract (scan_fwd.cu) plus:
//
//   scan_ckpt: ckpt (B, nl, N, Din) float32, nl = ceil(L / 32): ckpt[b, c] is
//              the state on entering tile c (t in [32c, 32c + 32)) in the
//              scan's direction of walk.
//   scan_bwd:  from ckpt and dy (B, L, Din): du, ddelta (B, L, Din),
//              dBp, dCp (B, L, N), dA (Din, N), dD (Din,), all float32.
//
// Per step of the walk (t in walk order s, a_s = exp(delta_s A)):
//   g_s  = Cp_s dy_s + a_{s+1} g_{s+1}            cotangent of h_s
//   da_s = g_s h_{s-1}
//   ddelta_s = sum_n da_s a_s A + u_s sum_n g_s Bp_s,  du_s = delta_s sum_n g_s Bp_s + D dy_s
//   dBp_s = sum_d g_s delta_s u_s,  dCp_s = sum_d h_s dy_s
//   dA += da_s a_s delta_s,  dD += dy_s u_s.
//
// Design. The TPU kernels got three things from their sequential grid that
// Hopper blocks do not have; each is replaced as follows.
//  (i) The states of a tile. The block (one batch row, 256 / N channels, as the
//      forward) reloads the tile's entry state from ckpt and recomputes the 32
//      states of the tile into registers (32 a thread, fully unrolled loops,
//      so no shared memory holds them); a_s is recomputed, not stored.
//  (ii) The cotangent carry g crosses tiles in a register of the same thread:
//      the block walks its tiles against the scan's direction.
//  (iii) Sums across blocks. dBp and dCp sum over all Din channels: the block
//      sums its own channels for each (step, state) from shared memory, in
//      order, and writes one partial per channel tile; dA and dD sum over
//      every batch row: each block writes its row's sums. A second kernel adds
//      the partials in a fixed order. No atomics: two calls give the same bits.
//  Sums over a whole row (dA, dD) are taken per tile and then across tiles,
//  which keeps their float32 rounding near sqrt(L / 32) tiles' worth.
//
// What bounds it on an H100. Bytes: u, delta, dy read and du, ddelta written
// (20 B per token-channel) plus Bp, Cp, dBp, dCp and ckpt: 10.5 KB a token at
// Din = 512, 0.42 ms per 2^17 tokens at 3.35 TB/s. Operations: at least one exp
// per token-channel-state on the special-function units, as the forward (0.26
// ms per 2^17 tokens). This kernel takes two exps per step (one per pass) and
// writes and reads 2 * Din / DT partials of dBp and dCp, about 0.54 GB at
// 2^17 tokens; like the forward, it is held back mostly by the sequential walk.
#include "scan_common.cuh"

namespace scan {

template <int N>
__global__ void __launch_bounds__(kThreads) scan_ckpt_kernel(const float* __restrict__ u,
                                                             const float* __restrict__ delta,
                                                             const float* __restrict__ A,
                                                             const float* __restrict__ Bp, float* __restrict__ ckpt,
                                                             int L, int din, long long b_sb, long long b_st,
                                                             int reverse) {
  constexpr int DT = channels_per_block(N);
  __shared__ float s_u[kChunk * DT], s_d[kChunk * DT];
  __shared__ float s_b[kChunk * N];
  __shared__ float s_h[N * DT];  // the entry state, [state][channel], for row-wise stores

  const int tiles = din / DT;
  const int b = blockIdx.x / tiles;
  const int d0 = (blockIdx.x - b * tiles) * DT;
  const int dl = threadIdx.x / N, n = threadIdx.x - dl * N;
  const float a_dn = A[(d0 + dl) * N + n];
  const long long base = (long long)b * L * din;
  const int nl = (L + kChunk - 1) / kChunk;

  float h = 0.f;
  for (int k = 0; k < nl; ++k) {
    const int c = reverse ? nl - 1 - k : k;
    const int t_lo = c * kChunk;
    const int len = min(kChunk, L - t_lo);
    s_h[n * DT + dl] = h;
    load_rows<DT>(s_u, u, base, din, d0, t_lo, len);
    load_rows<DT>(s_d, delta, base, din, d0, t_lo, len);
    load_state_rows<N>(s_b, Bp, b_sb, b_st, b, t_lo, len);
    __syncthreads();
    const long long out = ((long long)b * nl + c) * N * din + d0;
    for (int k2 = threadIdx.x; k2 < N * DT; k2 += kThreads) {
      const int nn = k2 / DT, dd = k2 - nn * DT;
      ckpt[out + (long long)nn * din + dd] = s_h[k2];
    }
    for (int j = 0; j < len; ++j) {
      const int i = reverse ? len - 1 - j : j;
      const float dt = s_d[i * DT + dl];
      h = expf(dt * a_dn) * h + (dt * s_u[i * DT + dl]) * s_b[i * N + n];
    }
    __syncthreads();
  }
}

template <int N>
__host__ __device__ constexpr size_t bwd_smem_floats() {
  // u, delta, dy, du, ddelta tiles; Bp, Cp tiles; two (step, thread) product
  // buffers for the dBp / dCp channel sums; the entry-state transpose.
  return 5 * kChunk * channels_per_block(N) + 2 * kChunk * N + 2 * kChunk * kThreads + kThreads;
}

template <int N>
__global__ void __launch_bounds__(kThreads) scan_bwd_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bp, const float* __restrict__ Cp, const float* __restrict__ Dsk,
    const float* __restrict__ dy, const float* __restrict__ ckpt, float* __restrict__ du,
    float* __restrict__ ddelta, float* __restrict__ part_db, float* __restrict__ part_dc,
    float* __restrict__ part_da, float* __restrict__ part_dd, int batch, int L, int din, long long b_sb,
    long long b_st, long long c_sb, long long c_st, int reverse) {
  constexpr int DT = channels_per_block(N);
  extern __shared__ float smem[];
  float* s_u = smem;
  float* s_d = s_u + kChunk * DT;
  float* s_dy = s_d + kChunk * DT;
  float* s_du = s_dy + kChunk * DT;
  float* s_dd = s_du + kChunk * DT;
  float* s_b = s_dd + kChunk * DT;
  float* s_c = s_b + kChunk * N;
  float* s_gb = s_c + kChunk * N;          // [step][thread]: g * delta * u
  float* s_hc = s_gb + kChunk * kThreads;  // [step][thread]: h * dy
  float* s_h = s_hc + kChunk * kThreads;   // entry state, [state][channel]

  const int tiles = din / DT;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int d0 = tile * DT;
  const int dl = threadIdx.x / N, n = threadIdx.x - dl * N;
  const int d = d0 + dl;
  const float a_dn = A[d * N + n];
  const float dsk = Dsk[d];
  const long long base = (long long)b * L * din;
  const int nl = (L + kChunk - 1) / kChunk;

  float g = 0.f, da_sum = 0.f, dd_sum = 0.f;
  for (int k = 0; k < nl; ++k) {
    // Tiles against the forward walk: the last tile of the walk first.
    const int c = reverse ? k : nl - 1 - k;
    const int t_lo = c * kChunk;
    const int len = min(kChunk, L - t_lo);
    load_rows<DT>(s_u, u, base, din, d0, t_lo, len);
    load_rows<DT>(s_d, delta, base, din, d0, t_lo, len);
    load_rows<DT>(s_dy, dy, base, din, d0, t_lo, len);
    load_state_rows<N>(s_b, Bp, b_sb, b_st, b, t_lo, len);
    load_state_rows<N>(s_c, Cp, c_sb, c_st, b, t_lo, len);
    const long long ck = ((long long)b * nl + c) * N * din + d0;
    for (int k2 = threadIdx.x; k2 < N * DT; k2 += kThreads) {
      const int nn = k2 / DT, dd = k2 - nn * DT;
      s_h[k2] = ckpt[ck + (long long)nn * din + dd];
    }
    __syncthreads();

    // Pass 1: the tile's states, in walk order j (j = 0 is the first step the
    // forward took in this tile).
    const float h_in = s_h[n * DT + dl];
    float hs[kChunk];
    float h = h_in;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < len) {
        const int i = reverse ? len - 1 - j : j;
        const float dt = s_d[i * DT + dl];
        h = expf(dt * a_dn) * h + (dt * s_u[i * DT + dl]) * s_b[i * N + n];
      }
      hs[j] = h;
    }

    // Pass 2: the cotangent recurrence, last step of the tile first.
    float da_tile = 0.f, dd_tile = 0.f;
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j < len) {
        const int i = reverse ? len - 1 - j : j;
        const float dt = s_d[i * DT + dl], ut = s_u[i * DT + dl], dyt = s_dy[i * DT + dl];
        const float a = expf(dt * a_dn);
        const float h_prev = j == 0 ? h_in : hs[j > 0 ? j - 1 : 0];
        g = s_c[i * N + n] * dyt + g;
        const float da = g * h_prev;
        const float via_a = sum_states<N>(da * a * a_dn);
        const float via_b = sum_states<N>(g * s_b[i * N + n]);
        if (n == 0) {
          s_dd[i * DT + dl] = via_a + via_b * ut;
          s_du[i * DT + dl] = via_b * dt + dsk * dyt;
          dd_tile += dyt * ut;
        }
        s_gb[i * kThreads + threadIdx.x] = g * (dt * ut);
        s_hc[i * kThreads + threadIdx.x] = hs[j] * dyt;
        da_tile += da * a * dt;
        g = a * g;  // the carry into the step before
      }
    }
    da_sum += da_tile;
    dd_sum += dd_tile;
    __syncthreads();

    store_rows<DT>(du, s_du, base, din, d0, t_lo, len);
    store_rows<DT>(ddelta, s_dd, base, din, d0, t_lo, len);
    // This tile's channel sums of dBp, dCp: channels in order.
    const long long part = (((long long)tile * batch + b) * L + t_lo) * N;
    for (int k2 = threadIdx.x; k2 < len * N; k2 += kThreads) {
      const int i = k2 / N, nn = k2 - i * N;
      float sb = 0.f, sc = 0.f;
#pragma unroll 8
      for (int q = 0; q < DT; ++q) {
        sb += s_gb[i * kThreads + q * N + nn];
        sc += s_hc[i * kThreads + q * N + nn];
      }
      part_db[part + k2] = sb;
      part_dc[part + k2] = sc;
    }
    __syncthreads();
  }
  part_da[((long long)b * din + d) * N + n] = da_sum;
  if (n == 0) part_dd[(long long)b * din + d] = dd_sum;
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
static int launch_ckpt(const float* u, const float* delta, const float* A, const float* Bp, float* ckpt, int batch,
                       int L, int din, long long b_sb, long long b_st, int reverse, cudaStream_t stream) {
  const int blocks = batch * (din / channels_per_block(N));
  scan_ckpt_kernel<N><<<blocks, kThreads, 0, stream>>>(u, delta, A, Bp, ckpt, L, din, b_sb, b_st, reverse);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_bwd(const float* u, const float* delta, const float* A, const float* Bp, const float* Cp,
                      const float* D, const float* dy, const float* ckpt, float* scratch, float* du, float* ddelta,
                      float* dbp, float* dcp, float* da, float* dd, int batch, int L, int din, long long b_sb,
                      long long b_st, long long c_sb, long long c_st, int reverse, cudaStream_t stream) {
  const int tiles = din / channels_per_block(N);
  const size_t smem = bwd_smem_floats<N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_bc = (long long)batch * L * N;
  float* part_db = scratch;
  float* part_dc = part_db + tiles * n_bc;
  float* part_da = part_dc + tiles * n_bc;
  float* part_dd = part_da + (long long)batch * din * N;
  scan_bwd_kernel<N><<<batch * tiles, kThreads, smem, stream>>>(u, delta, A, Bp, Cp, D, dy, ckpt, du, ddelta, part_db,
                                                                part_dc, part_da, part_dd, batch, L, din, b_sb, b_st,
                                                                c_sb, c_st, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = n_bc + (long long)din * N + din;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  scan_bwd_reduce<<<blocks, 256, 0, stream>>>(part_db, part_dc, part_da, part_dd, dbp, dcp, da, dd, tiles, batch, L,
                                              din, N);
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

extern "C" int scan_ckpt(const float* u, const float* delta, const float* A, const float* Bp, float* ckpt, int batch,
                         int L, int din, int n, long long b_sb, long long b_st, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!scan::valid_shape(batch, L, din, n)) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 8: return scan::launch_ckpt<8>(u, delta, A, Bp, ckpt, batch, L, din, b_sb, b_st, reverse, s);
    case 16: return scan::launch_ckpt<16>(u, delta, A, Bp, ckpt, batch, L, din, b_sb, b_st, reverse, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
