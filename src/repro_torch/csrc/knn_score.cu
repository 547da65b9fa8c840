// Batched kNN item scoring from precomputed neighbour lists.
//
// Replaces src/repro/kernels/knn_score/kernel.py::knn_scores_pallas
// (_score_kernel):
//   score[b, j] = sum_t w[b,t] * R[nbr[b,t], j]
//                 / max(sum_t w[b,t] * [R[nbr[b,t], j] != 0], 1e-12)
// with the querying user's rated items set to -inf.
//
// What bounds it on an H100: device memory.  Each output element costs
// 2k flops against k gathered floats, so the kernel must read every
// distinct neighbour row once and write the (B, m) scores once; at the
// serving shapes that is about a gigabyte at 3.35 TB/s.
//
// Design: one block per (tile of 256 items, query row b).  The block walks
// t = 0..k-1 in order, each thread reading nbrs[b,t] and w[b,t] (broadcast
// from L1) and one float of neighbour row nbr[b,t] at its item column, so
// every warp's row load is 32 consecutive floats.  The (B, k, m) gather of
// the einsum form never exists.  The seen mask reads the user's own row in
// the epilogue.
//
// Arithmetic: the sums are added over t in serial order with explicit
// round-to-nearest multiply and add (__fmul_rn / __fadd_rn), because nvcc
// would otherwise contract s += w * r into an FMA and the result would no
// longer match the plain version's serial loop bit for bit.  The division
// is IEEE (no fast math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr float EPS = 1e-12f;

__global__ void __launch_bounds__(THREADS)
knn_score_kernel(const float* __restrict__ ratings,
                 const float* __restrict__ w, const int* __restrict__ nbrs,
                 const int* __restrict__ users, float* __restrict__ out,
                 int k, int m) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= m) return;
  const float* wb = w + (int64_t)b * k;
  const int* nb = nbrs + (int64_t)b * k;
  float s = 0.f;
  float d = 0.f;
#pragma unroll 4
  for (int t = 0; t < k; ++t) {
    const float wt = wb[t];
    const float r = ratings[(int64_t)nb[t] * m + j];
    s = __fadd_rn(s, __fmul_rn(wt, r));
    d = __fadd_rn(d, __fmul_rn(wt, r != 0.f ? 1.f : 0.f));
  }
  float score = __fdiv_rn(s, fmaxf(d, EPS));
  if (ratings[(int64_t)users[b] * m + j] != 0.f) score = -INFINITY;
  out[(int64_t)b * m + j] = score;
}

}  // namespace

// ratings (N, m) float32; w (B, k) float32 >= 0; nbrs (B, k) and users (B,)
// int32, already clipped to [0, N) by the wrapper; out (B, m) float32.
extern "C" int knn_scores_f32(const void* ratings, const void* w,
                              const void* nbrs, const void* users, void* out,
                              int B, int k, int m, void* stream) {
  dim3 grid((m + THREADS - 1) / THREADS, B);
  knn_score_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ratings), static_cast<const float*>(w),
      static_cast<const int*>(nbrs), static_cast<const int*>(users),
      static_cast<float*>(out), k, m);
  return static_cast<int>(cudaGetLastError());
}
