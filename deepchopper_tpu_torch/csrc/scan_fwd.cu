// Selective scan of the Mamba mixer (Caduceus), forward.
//
// Replaces the Pallas TPU kernel `_scan_kernel` (deepchopper_tpu/ops/pallas_scan.py),
// entered there through `selective_scan_pallas`. Same contract:
//
//   u, delta (B, L, Din) float32, contiguous
//   A        (Din, N)    float32
//   Bp, Cp   (B, L, N)   float32, unit stride along N, strides (sb, st) otherwise
//   D        (Din,)      float32
//   y        (B, L, Din) float32:  h[t] = exp(delta[t] A) h[t-1] + delta[t] u[t] Bp[t],
//                                  y[t] = sum_n Cp[t, n] h[t][n] + D u[t],  h = 0 before the walk.
//   reverse != 0 walks t = L-1 .. 0 (flip(scan(flip(.))) without the flips).
//
// Design (scan_common.cuh). The TPU kernel walks L-chunks in grid order and
// carries the (bt, N, Din) state in VMEM scratch; Hopper blocks run in no
// order, so here one block owns a (batch row, 256 / N channels) slice of the
// state for the whole walk and keeps it in registers, one (channel, state) per
// thread: 32768 threads at the widest bucket (B = 4, Din = 512, N = 16). Each
// step costs one exp, a few FMAs and log2(N) shuffles for y's sum over states.
// A tile of 32 steps of u, delta, Bp, Cp is staged in shared memory; y leaves
// through shared memory. Reverse walks the tiles, and the steps inside each
// tile, from the end: a ragged last tile simply has fewer steps, so no padded
// step exists in either direction.
//
// What bounds it on an H100. Bytes: u, delta read once, y written once (12 B
// per token-channel) plus Bp, Cp: 6.3 KB a token at Din = 512, 0.25 ms per
// 2^17 tokens at 3.35 TB/s. Operations: Din * N = 8192 exps a token on the
// special-function units (16 a clock per SM): 0.26 ms per 2^17 tokens at 1.98
// GHz. The two are about equal; the design reads each input once and never
// writes the (B, L, Din, N) states, so what remains between it and the bound
// is latency: the walk is sequential in L, and at the wide buckets only 128
// blocks of 8 warps are in flight.
#include "scan_common.cuh"

namespace scan {

template <int N>
__global__ void __launch_bounds__(kThreads) scan_fwd_kernel(
    const float* __restrict__ u, const float* __restrict__ delta, const float* __restrict__ A,
    const float* __restrict__ Bp, const float* __restrict__ Cp, const float* __restrict__ Dsk, float* __restrict__ y,
    int L, int din, long long b_sb, long long b_st, long long c_sb, long long c_st, int reverse) {
  constexpr int DT = channels_per_block(N);
  __shared__ float s_u[kChunk * DT], s_d[kChunk * DT], s_y[kChunk * DT];
  __shared__ float s_b[kChunk * N], s_c[kChunk * N];

  const int tiles = din / DT;
  const int b = blockIdx.x / tiles;
  const int d0 = (blockIdx.x - b * tiles) * DT;
  const int dl = threadIdx.x / N, n = threadIdx.x - dl * N;
  const float a_dn = A[(d0 + dl) * N + n];
  const float dsk = Dsk[d0 + dl];
  const long long base = (long long)b * L * din;
  const int nl = (L + kChunk - 1) / kChunk;

  float h = 0.f;
  for (int k = 0; k < nl; ++k) {
    const int c = reverse ? nl - 1 - k : k;
    const int t_lo = c * kChunk;
    const int len = min(kChunk, L - t_lo);
    load_rows<DT>(s_u, u, base, din, d0, t_lo, len);
    load_rows<DT>(s_d, delta, base, din, d0, t_lo, len);
    load_state_rows<N>(s_b, Bp, b_sb, b_st, b, t_lo, len);
    load_state_rows<N>(s_c, Cp, c_sb, c_st, b, t_lo, len);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const int i = reverse ? len - 1 - j : j;
      const float dt = s_d[i * DT + dl], ut = s_u[i * DT + dl];
      h = expf(dt * a_dn) * h + (dt * ut) * s_b[i * N + n];
      const float yv = sum_states<N>(s_c[i * N + n] * h);
      if (n == 0) s_y[i * DT + dl] = yv + dsk * ut;
    }
    __syncthreads();
    // The next tile's loads write s_u.. only; s_y is next written after its
    // barrier, by which time these stores have read it.
    store_rows<DT>(y, s_y, base, din, d0, t_lo, len);
  }
}

template <int N>
static int launch(const float* u, const float* delta, const float* A, const float* Bp, const float* Cp,
                  const float* D, float* y, int batch, int L, int din, long long b_sb, long long b_st, long long c_sb,
                  long long c_st, int reverse, cudaStream_t stream) {
  const int blocks = batch * (din / channels_per_block(N));
  scan_fwd_kernel<N><<<blocks, kThreads, 0, stream>>>(u, delta, A, Bp, Cp, D, y, L, din, b_sb, b_st, c_sb, c_st,
                                                       reverse);
  return (int)cudaGetLastError();
}

}  // namespace scan

extern "C" int scan_fwd(const float* u, const float* delta, const float* A, const float* Bp, const float* Cp,
                        const float* D, float* y, int batch, int L, int din, int n, long long b_sb, long long b_st,
                        long long c_sb, long long c_st, int reverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!scan::valid_shape(batch, L, din, n)) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 8: return scan::launch<8>(u, delta, A, Bp, Cp, D, y, batch, L, din, b_sb, b_st, c_sb, c_st, reverse, s);
    case 16: return scan::launch<16>(u, delta, A, Bp, Cp, D, y, batch, L, din, b_sb, b_st, c_sb, c_st, reverse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
