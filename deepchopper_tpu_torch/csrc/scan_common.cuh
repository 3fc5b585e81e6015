// Device code shared by the selective-scan kernels (scan_fwd.cu's scan_fwd and
// scan_ckpt, scan_bwd.cu's scan_bwd): valid_shape, the checkpoint chunk, exp2
// on the special-function units and the cp.async helpers.
//
// Layout of scan_bwd.cu's kernel: one block per (batch row b, tile of DT
// channels), one thread per (channel, state) of the tile, kThreads = DT * N
// threads, thread index = channel * N + state. The block walks the whole
// sequence in tiles of kChunk steps (absolute tiles: tile c covers t in
// [c kChunk, (c+1) kChunk)); a tile's inputs are staged in shared memory once,
// so global memory is read in rows of DT (or N) floats. The state h of a
// thread lives in a register for the whole walk.
#pragma once

#include <cuda_runtime.h>

namespace scan {

constexpr int kThreads = 256;  // threads per block: DT channels x N states
constexpr int kChunk = 32;     // the checkpoint chunk (ops/scan.py CKPT_CHUNK); scan_bwd's tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int channels_per_block(int n) { return kThreads / n; }

// Shapes the kernels take: N in {8, 16}, Din a multiple of the block's channels.
inline bool valid_shape(int batch, int L, int din, int n) {
  return batch > 0 && L > 0 && (n == 8 || n == 16) && din > 0 && din % channels_per_block(n) == 0;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

}  // namespace scan
