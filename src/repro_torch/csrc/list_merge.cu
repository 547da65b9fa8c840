// k-way merge-insert of sorted inserts into ascending similarity lists.
//
// Replaces src/repro/kernels/list_merge/kernel.py::merge_insert_pallas
// (_merge_kernel): each row of width L takes k inserts (already gated and
// stable-sorted ascending by the wrapper) and drops the k smallest of the
// L + k merged entries.  Ties order as (value, age): row entries before
// inserts, inserts in burst order, exactly as k sequential
// searchsorted(side="right") inserts would.
//
// What bounds it on an H100: device memory.  It is pure data movement:
// every list value and id is read once and written once (16 bytes per
// entry), about 17 GB for a rotation of a 32k-user arena.
//
// Design: rank and scatter (src/repro/kernels/list_merge/ops.py::_merge_xla),
// not the TPU kernel's k + 1 shifted selects.  One block per row; the
// row's k inserts sit in shared memory.
//   row entry j  -> merged rank j + #{inserts <  row[j]}  (lower bound, smem)
//   insert t     -> merged rank #{row <= s_t} + t         (upper bound, row)
// The ranks are a permutation of 0..L+k-1, so each output slot rank - k is
// written exactly once and no two writes collide; ranks below k are the
// dropped minima.  Row reads and most writes are consecutive across a warp.
// ids are opaque int32 (rotation pads with -1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
             const float* __restrict__ sv, const int* __restrict__ si,
             float* __restrict__ out_v, int* __restrict__ out_i, int L,
             int k) {
  extern __shared__ float s_ins[];
  const int64_t row = blockIdx.x;
  const float* v = vals + row * L;
  const int* ids = idx + row * L;
  float* ov = out_v + row * L;
  int* oi = out_i + row * L;

  for (int t = threadIdx.x; t < k; t += THREADS) s_ins[t] = sv[row * k + t];
  __syncthreads();

  for (int j = threadIdx.x; j < L; j += THREADS) {
    const float x = v[j];
    int lo = 0, hi = k;                  // #{inserts < x}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_ins[mid] < x) lo = mid + 1; else hi = mid;
    }
    const int rank = j + lo;
    if (rank >= k) {
      ov[rank - k] = x;
      oi[rank - k] = ids[j];
    }
  }

  for (int t = threadIdx.x; t < k; t += THREADS) {
    const float s = s_ins[t];
    int lo = 0, hi = L;                  // #{row <= s}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (v[mid] <= s) lo = mid + 1; else hi = mid;
    }
    const int rank = lo + t;
    if (rank >= k) {
      ov[rank - k] = s;
      oi[rank - k] = si[row * k + t];
    }
  }
}

}  // namespace

// vals/idx (R, L) ascending rows; sv/si (R, k) gated inserts sorted
// ascending per row; out_v/out_i (R, L).  All contiguous.
extern "C" int merge_insert_f32(const void* vals, const void* idx,
                                const void* sv, const void* si, void* out_v,
                                void* out_i, int R, int L, int k,
                                void* stream) {
  merge_kernel<<<R, THREADS, k * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(sv), static_cast<const int*>(si),
      static_cast<float*>(out_v), static_cast<int*>(out_i), L, k);
  return static_cast<int>(cudaGetLastError());
}
