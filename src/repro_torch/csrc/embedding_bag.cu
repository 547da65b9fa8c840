// Sum-combiner EmbeddingBag: a weighted sum of gathered table rows per bag.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
// (_bag_kernel):
//   out[b, :] = sum_h table[idx[b, h], :] * w[b, h]
// with idx already clipped to [0, V) by the wrapper.
//
// What bounds it on an H100: device memory.  Each output element costs
// hot multiply-adds against hot gathered floats; the least it can move is
// each distinct table row once, plus idx, w and the output.
//
// Design: one thread per (bag, column).  The dim threads of a bag read
// idx[b, h] and w[b, h] (broadcast within the warp) and one float each of
// the gathered row, so a row's columns are read by neighbouring threads.
// The TPU kernel's scalar-prefetched row DMA becomes a plain indexed load.
//
// Arithmetic: the hot terms are added in serial order from 0.0 with
// explicit round-to-nearest multiply and add (__fmul_rn / __fadd_rn), as
// the Pallas kernel's revisited output block adds them; nvcc would
// otherwise contract the pair into an FMA, and the plain version's serial
// loop would no longer match bit for bit.  Zero-weight slots are not
// skipped: inf * 0 gives NaN, as in JAX.
//
// Offsets: idx * dim and the flat output index are computed in 64 bits (a
// 50M x 256 table holds 1.28e10 elements).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const float* __restrict__ table,
                     const int* __restrict__ idx, const float* __restrict__ w,
                     float* __restrict__ out, int64_t n_out, int hot,
                     int dim) {
  const int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (o >= n_out) return;
  const int64_t b = o / dim;
  const int d = (int)(o - b * dim);
  const int* ib = idx + b * hot;
  const float* wb = w + b * hot;
  float acc = 0.f;
  for (int h = 0; h < hot; ++h) {
    const float t = table[(int64_t)ib[h] * dim + d];
    acc = __fadd_rn(acc, __fmul_rn(t, wb[h]));
  }
  out[o] = acc;
}

}  // namespace

// table (V, dim) float32; idx (n_bags, hot) int32 in [0, V); w (n_bags,
// hot) float32; out (n_bags, dim) float32.
extern "C" int embedding_bag_f32(const void* table, const void* idx,
                                 const void* w, void* out, int n_bags,
                                 int hot, int dim, void* stream) {
  const int64_t n_out = (int64_t)n_bags * dim;
  const int64_t blocks = (n_out + THREADS - 1) / THREADS;
  embedding_bag_kernel<<<(unsigned)blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(out), n_out, hot,
      dim);
  return static_cast<int>(cudaGetLastError());
}
