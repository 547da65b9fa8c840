// Fused probe-interval intersection with the |Set_0| count (Algorithm 1
// line 9).
//
// Replaces src/repro/kernels/twin_probe/kernel.py::twin_probe_pallas
// (_make_kernel):
//   mask[x] = AND_i |rows[i, x] - s0[i]| <= tol,   count = sum_x mask[x]
// over c unsorted probe rows of width N.
//
// What bounds it on an H100: device memory, and at the serving shapes
// (c = 8, N ~ 33k, about 1 MB) the launch itself: each column costs c
// subtractions and compares against c * 4 bytes read.
//
// Design: one thread per column loops over the c probes; for each probe a
// warp reads 32 consecutive floats of that probe's row, so every load is
// coalesced.  The thread writes one mask byte.  The block's count comes
// from __syncthreads_count and is added with one atomicAdd per block into
// an int32 that the wrapper zeroes, so the (c, N) boolean intermediate and
// a second reduction pass never exist.  There is no early exit: every
// thread reads all c probes, so the kernel reads the c * N floats once.
// The TPU wrapper pads N to its block width with -3.0 and counts the
// padding too; this kernel masks the ragged edge and counts real columns
// only.
//
// Arithmetic: fabsf(r - s0) <= tol in fp32, as jnp computes it (the
// wrapper passes tol already rounded to fp32).  NaN never matches.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
twin_probe_kernel(const float* __restrict__ rows,
                  const float* __restrict__ s0, float tol,
                  bool* __restrict__ mask, int* __restrict__ count, int c,
                  int N) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  bool hit = x < N;
  if (hit) {
    for (int i = 0; i < c; ++i) {
      const float r = rows[(int64_t)i * N + x];
      hit &= fabsf(r - s0[i]) <= tol;   // no early exit: c loads each
    }
    mask[x] = hit;
  }
  // Every thread of the block reaches the barrier, in range or not.
  const int n = __syncthreads_count(hit);
  if (threadIdx.x == 0 && n > 0) atomicAdd(count, n);
}

}  // namespace

// rows (c, N) float32; s0 (c,) float32; mask (N,) bool; count a zeroed
// int32 scalar.
extern "C" int twin_probe_f32(const void* rows, const void* s0, float tol,
                              void* mask, void* count, int c, int N,
                              void* stream) {
  const int blocks = (N + THREADS - 1) / THREADS;
  twin_probe_kernel<<<blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(s0), tol,
      static_cast<bool*>(mask), static_cast<int*>(count), c, N);
  return static_cast<int>(cudaGetLastError());
}
