// Fused probe-interval intersection with the |Set_0| count (Algorithm 1
// line 9).
//
// Replaces src/repro/kernels/twin_probe/kernel.py::twin_probe_pallas
// (_make_kernel):
//   mask[x] = AND_i |rows[i, x] - s0[i]| <= tol,   count = sum_x mask[x]
// over c unsorted probe rows of width N.
//
// What bounds it on an H100: at the serving shapes (c = 8, N ~ 33k, about
// 1 MB) the launch itself.  The bytes (c * N floats in, N mask bytes out)
// take 0.3 us at 3.35 TB/s, below one launch; each column costs c
// subtractions and compares.  So the aim is one launch whose loads are
// all in flight at once.
//
// Design:
//   * One launch per call, nothing zeroed beforehand.  Each block adds
//     (1 << 32) | its count to one 64-bit ticket word: the high half
//     counts the blocks that have arrived, the low half sums their
//     counts, so the data travels in the atomic itself and needs no fence
//     and no second pass.  The block whose add sees every other block
//     arrived writes the total and sets the word back to 0, ready for the
//     next call on the stream.  The wrapper keeps one ticket per stream
//     (zeroed once, when the stream first calls), so calls on different
//     streams never share one.
//   * Four consecutive columns per thread.  Where N % 4 == 0 and the rows
//     start on a 16-byte boundary, each probe row is read with one float4
//     load per thread and the four mask bytes are stored as one 32-bit
//     word; otherwise the same thread reads its (up to) four columns with
//     scalar loads and stores bytes, masking the ragged edge.
//   * All c probe loads are issued before the first compare: c is a
//     template parameter for the server's probe counts (8 by default, and
//     4 and 16), so the loads unroll into registers; any other c runs in
//     chunks of 8 probes, each chunk's loads issued together.
//   * 64 threads a block: at N = 32,896 that is 8,224 threads in 129
//     blocks, one per SM on 129 of the 132 SMs, where 256-thread blocks
//     would fill 33.
// The TPU wrapper pads N to its block width with -3.0 and counts the
// padding too; this kernel counts real columns only.
//
// Arithmetic: fabsf(r - s0) <= tol in fp32, as jnp computes it (the
// wrapper passes tol already rounded to fp32).  NaN never matches.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int COLS = 4;      // columns per thread
constexpr int CHUNK = 8;     // probes per chunk when c is not a template

__device__ __forceinline__ bool near(float r, float s, float tol) {
  return fabsf(r - s) <= tol;
}

// The four columns' flags after probes [i0, i0 + n), all n loads issued
// before any compare.  n is a compile-time bound; probes at or past c are
// skipped.
template <int n>
__device__ __forceinline__ void probe_vec(const float* __restrict__ rows,
                                          const float* __restrict__ s0,
                                          float tol, int i0, int c,
                                          int64_t N, int64_t x0, bool* hit) {
  float4 v[n];
  float s[n];
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j < c) {
      v[j] = __ldg(reinterpret_cast<const float4*>(
          rows + (int64_t)(i0 + j) * N + x0));
      s[j] = __ldg(s0 + i0 + j);
    }
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j < c) {
      hit[0] &= near(v[j].x, s[j], tol);
      hit[1] &= near(v[j].y, s[j], tol);
      hit[2] &= near(v[j].z, s[j], tol);
      hit[3] &= near(v[j].w, s[j], tol);
    }
  }
}

template <int n>
__device__ __forceinline__ void probe_scalar(const float* __restrict__ rows,
                                             const float* __restrict__ s0,
                                             float tol, int i0, int c,
                                             int64_t N, int64_t x0,
                                             bool* hit) {
  float v[n][COLS];
  float s[n];
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j < c) {
      s[j] = __ldg(s0 + i0 + j);
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        if (x0 + k < N)
          v[j][k] = __ldg(rows + (int64_t)(i0 + j) * N + x0 + k);
    }
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j < c) {
#pragma unroll
      for (int k = 0; k < COLS; ++k)
        if (x0 + k < N) hit[k] &= near(v[j][k], s[j], tol);
    }
  }
}

// C > 0: exactly C probes, fully unrolled; C == 0: c probes in chunks.
template <int C>
__global__ void __launch_bounds__(THREADS)
twin_probe_kernel(const float* __restrict__ rows,
                  const float* __restrict__ s0, float tol,
                  uint8_t* __restrict__ mask, int* __restrict__ count,
                  unsigned long long* __restrict__ ticket, int c_rt, int N,
                  int vec) {
  const int c = C > 0 ? C : c_rt;
  const int64_t x0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * COLS;
  bool hit[COLS] = {true, true, true, true};
  int hits = 0;
  if (x0 < N) {
    if (vec) {
      if constexpr (C > 0) {
        probe_vec<C>(rows, s0, tol, 0, c, N, x0, hit);
      } else {
        for (int i0 = 0; i0 < c; i0 += CHUNK)
          probe_vec<CHUNK>(rows, s0, tol, i0, c, N, x0, hit);
      }
      const uint32_t word = (uint32_t)hit[0] | ((uint32_t)hit[1] << 8) |
                            ((uint32_t)hit[2] << 16) |
                            ((uint32_t)hit[3] << 24);
      reinterpret_cast<uint32_t*>(mask)[x0 / COLS] = word;
      hits = hit[0] + hit[1] + hit[2] + hit[3];
    } else {
      if constexpr (C > 0) {
        probe_scalar<C>(rows, s0, tol, 0, c, N, x0, hit);
      } else {
        for (int i0 = 0; i0 < c; i0 += CHUNK)
          probe_scalar<CHUNK>(rows, s0, tol, i0, c, N, x0, hit);
      }
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        if (x0 + k < N) {
          mask[x0 + k] = hit[k];
          hits += hit[k];
        }
      }
    }
  }

  // The block's count (a warp sum, then the two warps'), added to the
  // ticket with the block's arrival.
  __shared__ int warp_sum[THREADS / 32];
  hits = __reduce_add_sync(0xffffffffu, hits);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x / 32] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) sum += warp_sum[w];
    const unsigned long long seen =
        atomicAdd(ticket, (1ull << 32) | sum) + sum;
    if ((seen >> 32) == gridDim.x - 1) {      // every other block is in
      *count = (int)(seen & 0xffffffffull);
      *ticket = 0;
    }
  }
}

}  // namespace

// rows (c, N) float32, 16-byte aligned with N % 4 == 0 when vec != 0;
// s0 (c,) float32; mask (N,) bool, 4-byte aligned; count an int32; ticket
// a uint64 that is 0 between calls, one per stream.
extern "C" int twin_probe_f32(const void* rows, const void* s0, float tol,
                              void* mask, void* count, void* ticket, int c,
                              int N, int vec, void* stream) {
  const int blocks = (N + THREADS * COLS - 1) / (THREADS * COLS);
  auto* r = static_cast<const float*>(rows);
  auto* s = static_cast<const float*>(s0);
  auto* m = static_cast<uint8_t*>(mask);
  auto* n = static_cast<int*>(count);
  auto* t = static_cast<unsigned long long*>(ticket);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 4:
      twin_probe_kernel<4><<<blocks, THREADS, 0, st>>>(r, s, tol, m, n, t,
                                                       c, N, vec);
      break;
    case 8:
      twin_probe_kernel<8><<<blocks, THREADS, 0, st>>>(r, s, tol, m, n, t,
                                                       c, N, vec);
      break;
    case 16:
      twin_probe_kernel<16><<<blocks, THREADS, 0, st>>>(r, s, tol, m, n,
                                                        t, c, N, vec);
      break;
    default:
      twin_probe_kernel<0><<<blocks, THREADS, 0, st>>>(r, s, tol, m, n, t,
                                                       c, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
