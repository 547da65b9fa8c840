// k-way merge-insert of sorted inserts into ascending similarity lists, and
// the arena rotation's merge of its base rows.  Two entry points:
//
// merge_insert_f32 replaces src/repro/kernels/list_merge/kernel.py::
// merge_insert_pallas (_merge_kernel): each row of width L takes k inserts
// (already gated and stable-sorted ascending by the wrapper) and drops the
// k smallest of the L + k merged entries.  Ties order as (value, age): row
// entries before inserts, inserts in burst order, exactly as k sequential
// searchsorted(side="right") inserts would.
//
// merge_rows_f32 replaces no Pallas kernel: it takes the place of the
// preamble around the merge in the arena rotation
// (src/repro/core/rotation.py::_merge_base_rows: gate, stable argsort,
// take, the k head SENTINEL columns, then _fit_width's copy into the new
// arena), which on an H100 at Douban width took about 13 times the merge
// itself, mostly a stable segmented radix sort of every base row that
// gave back the order the row already had.  For base row r it computes,
// bit for bit, what that route gave:
//   1. gate: an entry whose id points into the old write region
//      (id >= n_base) becomes (SENTINEL, -1); an id of -1 is kept;
//   2. the gated row sorted stably ascending.  The row was ascending and
//      a gated entry takes SENTINEL, so that sort is a stable partition
//      into the entries below SENTINEL, at it and above it, each group in
//      row order.  Where no gated entry holds a value other than SENTINEL
//      (every row that onboarding leaves, since it writes only the new
//      user's own row), nothing moves and one pass writes the row.  Else
//      the block builds a bitmask of the gated entries in shared memory,
//      scans it, writes the row again with every entry at its partition
//      place, and adds 1 to *reordered (when it is not null);
//   3. k implicit head (SENTINEL, -1) entries, sorted stably with the row
//      (after any entries below SENTINEL, before the row's own SENTINELs),
//      then the row's k inserts U[0..k), r] (ids ids[0..k)), stable-sorted
//      ascending in shared memory, merged by the same rank and scatter as
//      merge_insert_f32; the k smallest entries are dropped;
//   4. the fit to the output width W: a head (SENTINEL, -1) pad where
//      W > L + k, the head trimmed where W < L + k.
// The row is written straight into row r of the output (the new arena) at
// the output's row stride, so no (b, L + k) temporary exists.  Rows must
// be ascending, as the arena keeps them.
//
// What bounds both on an H100: device memory.  They do no arithmetic:
// every list value and id is read once and written once (16 bytes an
// entry), about 17 GB for a rotation of a 32k-user arena.  A row that
// merge_rows_f32 reorders reads its ids twice more and its values once
// more, and writes again.
//
// Design: rank and scatter (src/repro/kernels/list_merge/ops.py::
// _merge_xla), not the TPU kernel's k + 1 shifted selects.  One block per
// row; the row's k inserts sit in shared memory.
//   row entry j  -> merged rank j + #{inserts <  row[j]}  (lower bound, smem)
//   insert t     -> merged rank #{row <= s_t} + t         (upper bound, row)
// The ranks are a permutation of 0..L+k-1, so each output slot rank - k is
// written exactly once and no two writes collide; ranks below k are the
// dropped minima.  Row reads and most writes are consecutive across a warp.
// merge_rows_f32 keeps enough bytes in flight to keep device memory busy:
// a thread loads UNROLL row entries at once, the next UNROLL go out
// before the current ones are written, and the row's first ones before
// its inserts are sorted.  ids are opaque int32 (rotation pads with -1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // a merge_kernel block
// A merge_rows_kernel block, and the row entries each of its threads loads
// at once: chosen on an H100 at Douban width (32,768 rows of 32,832, k =
// 64), where 512 x 8 took 7.6 ms and 256 or 1,024 threads, or 2 to 16
// entries, 8.1 to 10.9 ms.
constexpr int ROW_THREADS = 512;
constexpr int UNROLL = 8;
constexpr float SENTINEL = -2.0f;      // repro_torch.core.types.SENTINEL

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

// #{i < n : s[i] < x} of an ascending s (NaN last).
__device__ __forceinline__ int count_below(const float* s, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i < n : s[i] <= x} of an ascending s.
__device__ __forceinline__ int count_upto(const float* s, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Insert (a, burst position ta) sorts before insert (b, tb): ascending
// value, burst order among equal values, NaN last and in burst order:
// torch.sort(stable=True)'s order.
__device__ __forceinline__ bool insert_before(float a, int ta, float b,
                                              int tb) {
  if (a < b) return true;
  if (a == b || (a != a && b != b)) return ta < tb;
  return b != b;
}

// #{gated entries in [0, m)}: the words' scanned counts plus the bits of
// m's own word below it.  pre holds words + 1 counts.
__device__ __forceinline__ int gated_before(const unsigned* mask,
                                            const int* pre, int m) {
  const int w = m >> 5, b = m & 31;
  return pre[w] + (b ? __popc(mask[w] & ((1u << b) - 1u)) : 0);
}

// Loads the row's entries j0 + u * ROW_THREADS (u < UNROLL) below L.
__device__ __forceinline__ void load_run(const float* v, const int* e, int L,
                                         int j0, float (&x)[UNROLL],
                                         int (&id)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int j = j0 + u * ROW_THREADS;
    if (j < L) {
      x[u] = v[j];
      id[u] = e[j];
    }
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
merge_rows_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                  int ld_in, const float* __restrict__ U, int ld_u,
                  const int* __restrict__ ids, const int* __restrict__ rows,
                  int row0, float* __restrict__ out_v, int* __restrict__ out_i,
                  int ld_out, int L, int k, int W, int n_base,
                  int* __restrict__ reordered) {
  extern __shared__ float smem[];
  const int words = (L + 31) >> 5;
  float* s_raw = smem;                                  // inserts, burst order
  float* s_val = s_raw + k;                             // ... sorted
  int* s_id = reinterpret_cast<int*>(s_val + k);        // ... their ids
  unsigned* s_mask = reinterpret_cast<unsigned*>(s_id + k);  // gated bits
  int* s_pre = reinterpret_cast<int*>(s_mask + words);  // words + 1 counts
  __shared__ int s_warp[ROW_THREADS / 32];

  const int64_t r = rows ? (int64_t)rows[blockIdx.x]
                         : (int64_t)row0 + blockIdx.x;
  const float* v = vals + r * ld_in;
  const int* e = idx + r * ld_in;
  float* ov = out_v + r * ld_out;
  int* oi = out_i + r * ld_out;

  // The row's first run is loaded while its inserts are sorted.
  float x[UNROLL], xn[UNROLL];
  int id[UNROLL], idn[UNROLL];
  load_run(v, e, L, threadIdx.x, x, id);

  // The row's inserts, sorted by rank: insert t goes to the number of
  // inserts that sort before it.
  for (int t = threadIdx.x; t < k; t += ROW_THREADS)
    s_raw[t] = U[(int64_t)t * ld_u + r];
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += ROW_THREADS) {
    const float y = s_raw[t];
    int rank = 0;
    for (int q = 0; q < k; ++q) rank += insert_before(s_raw[q], q, y, t);
    s_val[rank] = y;
    s_id[rank] = ids[t];
  }
  __syncthreads();

  // Ranks run over the row sorted with its head pad: the entries below
  // SENTINEL, the k head (SENTINEL, -1) entries, then the rest of the row.
  // Merged rank -> output column rank - off; ranks below k are the
  // dropped minima, columns below 0 are trimmed by the fit.
  const int off = L + 2 * k - W;
  const int rmin = max(k, off);
  for (int c = threadIdx.x; c < W - L - k; c += ROW_THREADS) {  // fit's pad
    ov[c] = SENTINEL;
    oi[c] = -1;
  }
  const int head_rank = count_below(s_val, k, SENTINEL);  // inserts below
  // Entries below SENTINEL: none in a similarity list, whose values are
  // cosines or SENTINEL, so one load settles it.
  const int a = L > 0 && v[0] < SENTINEL ? count_below(v, L, SENTINEL) : 0;
  for (int j = threadIdx.x; j < k; j += ROW_THREADS) {   // the k head entries
    const int rank = a + j + head_rank;
    if (rank >= rmin) {
      ov[rank - off] = SENTINEL;
      oi[rank - off] = -1;
    }
  }

  // The pass that holds while nothing moves: the gated row is the row
  // with its gated ids at -1, so an insert's count runs over the row.
  // Each run's loads go out before the run before it is written.
  bool moved = false;
  for (int j0 = threadIdx.x; j0 < L; j0 += ROW_THREADS * UNROLL) {
    load_run(v, e, L, j0 + ROW_THREADS * UNROLL, xn, idn);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROW_THREADS;
      if (j < L) {
        const bool gated = id[u] >= n_base;
        moved |= gated && x[u] != SENTINEL;
        const int rank = (j < a ? 0 : k) + j + count_below(s_val, k, x[u]);
        if (rank >= rmin) {
          ov[rank - off] = x[u];
          oi[rank - off] = gated ? -1 : id[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = xn[u];
      id[u] = idn[u];
    }
  }
  for (int t = threadIdx.x; t < k; t += ROW_THREADS) {  // the row is cached
    const float y = s_val[t];
    const int rank = (SENTINEL <= y ? k : 0) + count_upto(v, L, y) + t;
    if (rank >= rmin) {
      ov[rank - off] = y;
      oi[rank - off] = s_id[t];
    }
  }
  if (!__syncthreads_or(moved)) return;

  // A gated entry held a real value: partition.  The barrier above orders
  // this pass's writes after the first pass's, which they all replace but
  // the fit's pad.
  if (threadIdx.x == 0 && reordered) atomicAdd(reordered, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = warp; w < words; w += ROW_THREADS / 32) {
    const int j = (w << 5) + lane;
    const unsigned bits = __ballot_sync(0xffffffffu,
                                        j < L && e[j] >= n_base);
    if (lane == 0) s_mask[w] = bits;
  }
  __syncthreads();
  // s_pre[w] = gated entries in [0, 32 w): a thread counts a run of
  // consecutive words, and the runs' counts are scanned over the block.
  const int per = (words + ROW_THREADS - 1) / ROW_THREADS;
  const int w0 = min(words, threadIdx.x * per), w1 = min(words, w0 + per);
  int count = 0;
  for (int w = w0; w < w1; ++w) count += __popc(s_mask[w]);
  int incl = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - count;
  for (int q = 0; q < warp; ++q) run += s_warp[q];
  for (int w = w0; w < w1; ++w) {
    s_pre[w] = run;
    run += __popc(s_mask[w]);
  }
  if (threadIdx.x == ROW_THREADS - 1) s_pre[words] = run;
  __syncthreads();

  // Groups: [0, a) below SENTINEL, [a, h) at it, [h, L) above; gated
  // entries all join the middle group.
  const int h = count_upto(v, L, SENTINEL);
  const int g_a = gated_before(s_mask, s_pre, a);
  const int g_h = gated_before(s_mask, s_pre, h);
  const int n_below = a - g_a;
  const int n_upto = h - g_h + s_pre[words];   // below and at SENTINEL
  for (int j = threadIdx.x; j < k; j += ROW_THREADS) {
    const int rank = n_below + j + head_rank;
    if (rank >= rmin) {
      ov[rank - off] = SENTINEL;
      oi[rank - off] = -1;
    }
  }
  for (int t = threadIdx.x; t < k; t += ROW_THREADS) {
    const float s = s_val[t];
    const int ub = count_upto(v, L, s);
    const int g_ub = gated_before(s_mask, s_pre, ub);
    const int upto = SENTINEL <= s ? k + n_upto + (ub - h) - (g_ub - g_h)
                                   : ub - g_ub;
    const int rank = upto + t;
    if (rank >= rmin) {
      ov[rank - off] = s;
      oi[rank - off] = s_id[t];
    }
  }
  for (int j0 = threadIdx.x; j0 < L; j0 += ROW_THREADS * UNROLL) {
    load_run(v, e, L, j0, x, id);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROW_THREADS;
      if (j < L) {
        const int g_j = gated_before(s_mask, s_pre, j);
        int pos;
        if (id[u] >= n_base) {
          const int m = min(max(j, a), h);
          pos = n_below + g_j + (m - a) -
                (gated_before(s_mask, s_pre, m) - g_a);
          x[u] = SENTINEL;
          id[u] = -1;
        } else if (j < a) {
          pos = j - g_j;
        } else if (j < h) {
          pos = j;
        } else {
          pos = n_upto + (j - h) - (g_j - g_h);
        }
        const int rank =
            (pos < n_below ? 0 : k) + pos + count_below(s_val, k, x[u]);
        if (rank >= rmin) {
          ov[rank - off] = x[u];
          oi[rank - off] = id[u];
        }
      }
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

// Shared memory of one merge_rows_f32 block: the row's inserts three times
// (burst order, sorted, sorted ids) and the bitmask with its scan.
static size_t merge_rows_smem(int L, int k) {
  const size_t words = ((size_t)L + 31) / 32;
  return 12 * (size_t)k + 4 * (2 * words + 1);
}

// The rotation's merge of n_rows base rows: row r = rows[b] (rows not
// null) or row0 + b of vals/idx (ld_in apart) with its inserts U[t, r]
// (t < k, ld_u apart) and their ids ids[t], written to row r of
// out_v/out_i (ld_out apart) at width W.  reordered may be null.
extern "C" int merge_rows_f32(const void* vals, const void* idx, int ld_in,
                              const void* U, int ld_u, const void* ids,
                              const void* rows, int row0, int n_rows,
                              void* out_v, void* out_i, int ld_out, int L,
                              int k, int W, int n_base, void* reordered,
                              void* stream) {
  const size_t smem = merge_rows_smem(L, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows == 0) return 0;
  merge_rows_kernel<<<n_rows, ROW_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), ld_in,
      static_cast<const float*>(U), ld_u, static_cast<const int*>(ids),
      static_cast<const int*>(rows), row0, static_cast<float*>(out_v),
      static_cast<int*>(out_i), ld_out, L, k, W, n_base,
      static_cast<int*>(reordered));
  return static_cast<int>(cudaGetLastError());
}

