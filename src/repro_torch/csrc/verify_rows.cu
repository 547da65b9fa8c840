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
// Design: one block per candidate row, each thread keeping its own AND,
// and __syncthreads_and reduces the block's flags; thread 0 ANDs in
// valid[i].  There is no early exit: every row is read in full, whether
// or not a mismatch came early, so the reads are the s * m elements the
// bound counts.  r0 is read by every block and stays in L2.
//
// Wide loads on rows that are not 16-byte aligned: at Douban width
// m = 58,541 is odd, so row i starts at byte i * m * sizeof(T) and most
// rows start off a 16-byte boundary.  Each row is read in three parts:
// the head up to its first 16-byte boundary (fewer than 16 bytes, scalar
// loads), a body of aligned uint4 loads (streamed: read once; each thread
// issues 4 of them before comparing any, so that enough bytes are in
// flight), and a scalar tail.  r0's bytes that match a body chunk sit at
// another offset s (mod 16) than the chunk, the same for the whole row;
// they are put together from two aligned uint4 loads of r0 with
// __funnelshift_r (s is a multiple of 4 for f32, so the shift is by whole
// words there).
// Arithmetic on the words: int8 values are equal exactly when their bits
// are, so int8 compares whole 4-byte words; f32 compares each word as a
// float, so -0.0 == 0.0 holds and NaN == NaN does not, as with jnp's ==
// (and as the scalar head and tail compare).  The kernel is instantiated
// for float32 and int8 (the dtypes after the wrapper's promotion of C and
// r0).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int U = 4;               // chunks in flight per thread

template <typename T>
__device__ __forceinline__ int word_eq(uint32_t a, uint32_t b);

template <>
__device__ __forceinline__ int word_eq<float>(uint32_t a, uint32_t b) {
  return __uint_as_float(a) == __uint_as_float(b);
}

template <>
__device__ __forceinline__ int word_eq<int8_t>(uint32_t a, uint32_t b) {
  return a == b;
}

template <typename T>
__device__ __forceinline__ int chunk_eq(const uint4& c, uint32_t w0,
                                        uint32_t w1, uint32_t w2,
                                        uint32_t w3) {
  return word_eq<T>(c.x, w0) & word_eq<T>(c.y, w1) & word_eq<T>(c.z, w2) &
         word_eq<T>(c.w, w3);
}

// nb aligned chunks of the row at c against r0's matching chunks.  Each
// thread takes chunks b0, b0 + THREADS, ... in batches of U whose loads
// are all issued before any compare, so a row costs one or two round
// trips to memory.  r0's chunk b is aligned too (at r) when SHIFTED is
// false; otherwise it starts 4 * Q + sh / 8 bytes past the aligned r + b
// (0 < 4 Q + sh / 8 < 16): words Q..Q+4 of the 32 bytes at r + b, shifted
// right by sh bits.
template <typename T, bool SHIFTED, int Q>
__device__ __forceinline__ int body_eq(const uint4* __restrict__ c,
                                       const uint4* __restrict__ r, int nb,
                                       int sh) {
  int eq = 1;
  for (int b0 = threadIdx.x; b0 < nb; b0 += THREADS * U) {
    uint4 cv[U], lo[U], hi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + THREADS * u;
      if (b < nb) {
        cv[u] = __ldcs(c + b);                  // read once: streamed
        lo[u] = __ldg(r + b);
        if constexpr (SHIFTED) hi[u] = __ldg(r + b + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (b0 + THREADS * u >= nb) break;
      if constexpr (SHIFTED) {
        const uint32_t x[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                               hi[u].x, hi[u].y, hi[u].z, hi[u].w};
        eq &= chunk_eq<T>(cv[u], __funnelshift_r(x[Q], x[Q + 1], sh),
                          __funnelshift_r(x[Q + 1], x[Q + 2], sh),
                          __funnelshift_r(x[Q + 2], x[Q + 3], sh),
                          __funnelshift_r(x[Q + 3], x[Q + 4], sh));
      } else {
        eq &= chunk_eq<T>(cv[u], lo[u].x, lo[u].y, lo[u].z, lo[u].w);
      }
    }
  }
  return eq;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
verify_rows_kernel(const T* __restrict__ C, const T* __restrict__ r0,
                   const bool* __restrict__ valid, bool* __restrict__ out,
                   int m) {
  constexpr int E = sizeof(T);
  const T* row = C + (int64_t)blockIdx.x * m;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(m, ((16 - off) & 15) / E);
  const int nb = static_cast<int>((int64_t)(m - head) * E / 16);
  const int tail = head + nb * (16 / E);

  int eq = 1;
  if (threadIdx.x < head) eq &= row[threadIdx.x] == r0[threadIdx.x];
  for (int j = tail + threadIdx.x; j < m; j += THREADS) eq &= row[j] == r0[j];
  if (nb > 0) {
    const uint4* c = reinterpret_cast<const uint4*>(row + head);
    const uintptr_t ra = reinterpret_cast<uintptr_t>(r0 + head);
    const uint4* r = reinterpret_cast<const uint4*>(ra & ~uintptr_t(15));
    const int s = static_cast<int>(ra & 15);        // the same for the row
    const int sh = 8 * (s & 3);
    switch (s >> 2) {
      case 0:
        eq &= s == 0 ? body_eq<T, false, 0>(c, r, nb, 0)
                     : body_eq<T, true, 0>(c, r, nb, sh);
        break;
      case 1: eq &= body_eq<T, true, 1>(c, r, nb, sh); break;
      case 2: eq &= body_eq<T, true, 2>(c, r, nb, sh); break;
      default: eq &= body_eq<T, true, 3>(c, r, nb, sh); break;
    }
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
