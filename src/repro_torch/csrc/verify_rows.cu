// Masked row-equality verification of TwinSearch candidates (Algorithm 1
// lines 10-15).
//
// Replaces src/repro/kernels/verify_rows/kernel.py::verify_rows_pallas
// (_verify_kernel):
//   out[i] = valid[i] AND (C[i, j] == r0[j] for every j < m)
// for an (s, m) block of gathered candidate rows.
//
// What bounds it on an H100: device memory.  It does one compare per
// element read, so it can go no faster than one pass over the s * m
// candidate elements (107 MB in f32, 27 MB in int8 at the Douban-width
// candidate block).
//
// Design: one block per candidate row strides over the m columns, each
// thread keeping its own AND, and __syncthreads_and reduces the block's
// flags; thread 0 ANDs in valid[i].  There is no early exit: every row is
// read in full, whether or not a mismatch came early, so the reads are
// the s * m elements the bound counts.  r0 is read by every block and
// stays in L2.
//
// Alignment: rows are read with scalar loads.  At Douban width m = 58,541
// is odd, so row i starts at byte i * m * sizeof(T) and most rows do not
// start on a 16-byte boundary; a float4 (or char4) view of a row would
// fault or misread.
//
// Arithmetic: values are compared as values, not as bits: -0.0 == 0.0
// holds and NaN == NaN does not, as with jnp's ==.  The kernel is
// instantiated for float32 and int8 (the dtypes after the wrapper's
// promotion of C and r0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

template <typename T>
__global__ void __launch_bounds__(THREADS)
verify_rows_kernel(const T* __restrict__ C, const T* __restrict__ r0,
                   const bool* __restrict__ valid, bool* __restrict__ out,
                   int m) {
  const T* row = C + (int64_t)blockIdx.x * m;
  int eq = 1;
#pragma unroll 4
  for (int j = threadIdx.x; j < m; j += THREADS) {
    eq &= row[j] == r0[j];
  }
  const int all = __syncthreads_and(eq);
  if (threadIdx.x == 0) out[blockIdx.x] = all && valid[blockIdx.x];
}

template <typename T>
int launch(const void* C, const void* r0, const void* valid, void* out,
           int s, int m, void* stream) {
  verify_rows_kernel<T><<<s, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(C), static_cast<const T*>(r0),
      static_cast<const bool*>(valid), static_cast<bool*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C (s, m) and r0 (m,) of one dtype; valid (s,) bool; out (s,) bool.
extern "C" int verify_rows_f32(const void* C, const void* r0,
                               const void* valid, void* out, int s, int m,
                               void* stream) {
  return launch<float>(C, r0, valid, out, s, m, stream);
}

extern "C" int verify_rows_i8(const void* C, const void* r0,
                              const void* valid, void* out, int s, int m,
                              void* stream) {
  return launch<int8_t>(C, r0, valid, out, s, m, stream);
}
