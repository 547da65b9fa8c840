// Masked row-equality verification of TwinSearch candidates (Algorithm 1
// lines 10-15), and beside it the arena health sweep (live_rows_f32, whose
// notes stand above it further down).
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

// ---------------------------------------------------------------------------
// The arena health sweep (live_rows_f32).
//
// Replaces no Pallas kernel: the JAX package checks the arena in plain jnp
// (src/repro/kernels/verify_rows/ops.py::arena_healthy), as the port did in
// plain PyTorch before (kernels/verify_rows/ref.py::live_rows_ok_ref, now
// the CPU's version).  For every live row r < n_live:
//   out[r] = every list value finite, and v[j] <= v[j + 1] for each pair
//            of the row (no pair across two rows)
//            AND every rating finite AND the norm finite and >= 0
// (-0.0 passes; NaN fails).  Pairs are compared as values, not through
// their difference: for finite values without flush-to-zero (this file is
// built without fast-math) b >= a holds exactly when torch.diff's b - a is
// >= 0, subnormal pairs included.
//
// What bounds it on an H100: device memory.  It is a pure stream, each
// live row's list, ratings and norm read once: 4 (L + m + 1) bytes a row
// and a flag byte written (12.0 GB, 3.6 ms at 3.35 TB/s, on the
// Douban-width arena of 32,832 rows, lists 32,832 wide, 58,541 items).
//
// Design: one block of SWEEP_THREADS per live row, so a row's verdict is
// one __syncthreads_and and thread 0 writes the flag with the norm's test.
// Each part of the row (list, then ratings) is read as a scalar head up to
// its first 16-byte boundary, a body of uint4 loads (streamed, SWEEP_U of
// them issued by each thread before any is tested) and a scalar tail: at
// 58,541 items most rating rows start off a 16-byte boundary.  The list's
// pair test needs each chunk's right neighbour: a warp reads a tile of
// 32 * SWEEP_U consecutive chunks, lane l's chunk at step u followed by
// lane l + 1's, lane 31's by lane 0's at step u + 1, handed over by one
// __shfl_sync a step; the tile's last chunk, the body's last, and the
// scalar head and tail load the value after them (one 4-byte load a 4 KB
// tile, which the neighbouring tile's own load brings to L2).  The list's
// tile loop is warp-uniform, so every lane takes every shuffle.  Rows at
// or past n_live are never read; nothing depends on the widths but the
// loop bounds.
// ---------------------------------------------------------------------------

constexpr int SWEEP_THREADS = 256;
constexpr int SWEEP_U = 8;          // 16-byte loads in flight a thread
constexpr int SWEEP_TILE = 32 * SWEEP_U;   // chunks a warp's tile

__device__ __forceinline__ int finite(uint32_t w) {
  return (w & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ int finite4(const uint4& c) {
  return finite(c.x) & finite(c.y) & finite(c.z) & finite(c.w);
}

// b may follow a in an ascending list.
__device__ __forceinline__ int ascends(uint32_t a, uint32_t b) {
  return __uint_as_float(b) >= __uint_as_float(a);
}

// Values of a row of n before its first 16-byte boundary (a float row
// starts 4-byte aligned).
__device__ __forceinline__ int head_of(const float* row, int n) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  return min(n, ((16 - off) & 15) / 4);
}

// Every value of the list row finite and every pair ascending (this
// thread's share).
__device__ int list_ok(const float* __restrict__ row, int L) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int head = head_of(row, L);
  const int nb = (L - head) / 4;
  const int tail = head + 4 * nb;
  int ok = 1;
  const int t = static_cast<int>(threadIdx.x);
  if (t < head) ok &= finite(w[t]) & (t + 1 >= L || ascends(w[t], w[t + 1]));
  for (int j = tail + t; j < L; j += SWEEP_THREADS)
    ok &= finite(w[j]) & (j + 1 >= L || ascends(w[j], w[j + 1]));
  const uint4* c = reinterpret_cast<const uint4*>(row + head);
  const int lane = t & 31;
  for (int t0 = (t >> 5) * SWEEP_TILE; t0 < nb;
       t0 += SWEEP_THREADS / 32 * SWEEP_TILE) {
    uint4 x[SWEEP_U];
#pragma unroll
    for (int u = 0; u < SWEEP_U; ++u) {
      const int b = t0 + 32 * u + lane;
      x[u] = b < nb ? __ldcs(c + b) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < SWEEP_U; ++u) {
      const int b = t0 + 32 * u + lane;
      // The first value of chunk b + 1: lane + 1's chunk at this step, or
      // for lane 31 lane 0's at the next.
      const uint32_t give = lane == 0 ? x[u + 1 < SWEEP_U ? u + 1 : u].x
                                      : x[u].x;
      const uint32_t next = __shfl_sync(0xffffffffu, give, (lane + 1) & 31);
      if (b < nb) {
        ok &= finite4(x[u]) & ascends(x[u].x, x[u].y) &
              ascends(x[u].y, x[u].z) & ascends(x[u].z, x[u].w);
        const int e = head + 4 * (b + 1);        // the value after the chunk
        if (b + 1 < nb && (lane < 31 || u + 1 < SWEEP_U))
          ok &= ascends(x[u].w, next);
        else if (e < L)
          ok &= ascends(x[u].w, w[e]);
      }
    }
  }
  return ok;
}

// Every value of the rating row finite (this thread's share).
__device__ int ratings_ok(const float* __restrict__ row, int m) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int head = head_of(row, m);
  const int nb = (m - head) / 4;
  const int tail = head + 4 * nb;
  int ok = 1;
  const int t = static_cast<int>(threadIdx.x);
  if (t < head) ok &= finite(w[t]);
  for (int j = tail + t; j < m; j += SWEEP_THREADS) ok &= finite(w[j]);
  const uint4* c = reinterpret_cast<const uint4*>(row + head);
  for (int b0 = t; b0 < nb; b0 += SWEEP_THREADS * SWEEP_U) {
    uint4 x[SWEEP_U];
#pragma unroll
    for (int u = 0; u < SWEEP_U; ++u) {
      const int b = b0 + SWEEP_THREADS * u;
      if (b < nb) x[u] = __ldcs(c + b);
    }
#pragma unroll
    for (int u = 0; u < SWEEP_U; ++u)
      if (b0 + SWEEP_THREADS * u < nb) ok &= finite4(x[u]);
  }
  return ok;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
live_rows_kernel(const float* __restrict__ vals, int ld_v, int L,
                 const float* __restrict__ ratings, int ld_r, int m,
                 const float* __restrict__ norms, bool* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const int ok = list_ok(vals + r * ld_v, L) &
                 ratings_ok(ratings + r * ld_r, m);
  const int all = __syncthreads_and(ok);
  if (threadIdx.x == 0) {
    const float n = norms[r];
    out[r] = all && finite(__float_as_uint(n)) && n >= 0.0f;
  }
}

}  // namespace

// The arena health sweep over rows [0, n_live): vals (>= n_live, L) f32
// lists ld_v apart, ratings (>= n_live, m) f32 ld_r apart, both with unit
// column stride; norms (>= n_live,) f32; out (n_live,) bool.
extern "C" int live_rows_f32(const void* vals, int ld_v, int L,
                             const void* ratings, int ld_r, int m,
                             const void* norms, void* out, int n_live,
                             void* stream) {
  if (n_live == 0) return 0;
  live_rows_kernel<<<n_live, SWEEP_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), ld_v, L,
      static_cast<const float*>(ratings), ld_r, m,
      static_cast<const float*>(norms), static_cast<bool*>(out));
  return static_cast<int>(cudaGetLastError());
}

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
