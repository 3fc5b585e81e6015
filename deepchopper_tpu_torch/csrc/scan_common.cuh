// Device code of the selective-scan kernels of scan_bwd.cu (scan_ckpt,
// scan_bwd); scan_fwd.cu, laid out otherwise, shares only valid_shape.
//
// Layout of those kernels: one block per (batch row b, tile of DT
// channels), one thread per (channel, state) of the tile, kThreads = DT * N
// threads, thread index = channel * N + state. The N states of a channel are N
// neighbouring lanes of one warp, so a sum over the states is log2(N)
// xor-shuffles. The block walks the whole sequence in tiles of kChunk steps
// (absolute tiles: tile c covers t in [c kChunk, (c+1) kChunk)); a tile's
// inputs are staged in shared memory once and its outputs leave through shared
// memory, so global memory is read and written in rows of DT (or N) floats.
// The state h of a thread lives in a register for the whole walk.
#pragma once

#include <cuda_runtime.h>

namespace scan {

constexpr int kThreads = 256;  // threads per block: DT channels x N states
constexpr int kChunk = 32;     // steps per tile; also the checkpoint chunk (ops/scan.py CKPT_CHUNK)

__host__ __device__ constexpr int channels_per_block(int n) { return kThreads / n; }

// Shapes the kernels take: N in {8, 16}, Din a multiple of the block's channels.
inline bool valid_shape(int batch, int L, int din, int n) {
  return batch > 0 && L > 0 && (n == 8 || n == 16) && din > 0 && din % channels_per_block(n) == 0;
}

// dst[i * DT + dl] = src[base + (t_lo + i) * din + d0 + dl] for i < len, dl < DT.
template <int DT>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, long long base, int din, int d0,
                                          int t_lo, int len) {
  for (int k = threadIdx.x; k < len * DT; k += kThreads) {
    const int i = k / DT, dl = k - i * DT;
    dst[k] = src[base + (long long)(t_lo + i) * din + d0 + dl];
  }
}

// The inverse of load_rows: a tile of DT channels back to (B, L, Din).
template <int DT>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, long long base, int din, int d0,
                                           int t_lo, int len) {
  for (int k = threadIdx.x; k < len * DT; k += kThreads) {
    const int i = k / DT, dl = k - i * DT;
    dst[base + (long long)(t_lo + i) * din + d0 + dl] = src[k];
  }
}

// dst[i * N + n] = src[b * sb + (t_lo + i) * st + n]: Bp or Cp rows, which may be
// strided slices of x_proj's output (unit stride along N).
template <int N>
__device__ __forceinline__ void load_state_rows(float* dst, const float* __restrict__ src, long long sb, long long st,
                                                int b, int t_lo, int len) {
  for (int k = threadIdx.x; k < len * N; k += kThreads) {
    const int i = k / N, n = k - i * N;
    dst[k] = src[(long long)b * sb + (long long)(t_lo + i) * st + n];
  }
}

// Sum over the N states of a channel (N neighbouring lanes). Every lane of the
// group gets the same bits: each butterfly step adds the same two values.
template <int N>
__device__ __forceinline__ float sum_states(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace scan
