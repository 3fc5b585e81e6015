// Runtime-setup kernel: y = x + 1 on one (8, 128) float32 tile.
//
// Replaces the Pallas TPU kernel `_triv` of `PredictEngine.runtime_setup`
// (deepchopper_tpu/infer/engine.py:316, its pallas_call at :336). There it
// takes the one-time runtime setup before the first real kernel runs, so the
// setup is timed as `stats.setup_s` and kept off the timed stream. In the port
// `PredictEngine.runtime_setup` builds and loads every kernel library first,
// then launches this one and checks its output: its first launch also creates
// the CUDA context's module state for the libraries it loaded.
//
//   x  (rows * cols,)  float32
//   y  (rows * cols,)  float32, y = x + 1
//
// One block a row, one thread a column. What bounds it on an H100: nothing but
// the launch. It moves 8 KB (2.4 ns at 3.35 TB/s) and does 1024 adds, so the
// time is the launch latency, a few microseconds.

#include <cuda_runtime.h>

namespace {

__global__ void setup_kernel(const float* __restrict__ x, float* __restrict__ y, int cols) {
  const int i = blockIdx.x * cols + threadIdx.x;
  y[i] = x[i] + 1.f;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.
int setup_fwd(const float* x, float* y, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > 1024) return (int)cudaErrorInvalidValue;
  setup_kernel<<<rows, cols, 0, static_cast<cudaStream_t>(stream)>>>(x, y, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
