// Sum-combiner EmbeddingBag: a weighted sum of gathered table rows per bag.
//
// Replaces src/repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas
// (_bag_kernel) and the elementwise steps of its wrapper (ops.py):
//   out[b, :] = sum_h table[clip(idx[b, h]), :] * (w[b, h] * mask[b, h])
// with clip(i) = min(max(i, 0), V - 1), w = 1 where no weights are given,
// and the mask's factor 1.0 or 0.0 where a mask is given.
//
// What bounds it on an H100: by bytes, device memory (each distinct table
// row once, plus idx, w, mask and the output).  In practice, the gathers:
// every (bag, slot) reads its row again, 2.1M row reads at xDeepFM's
// serve_bulk shape against 100k distinct rows, and each is a separate
// trip through L1, so the kernel takes most of its cold time even when
// every byte sits in L2 (PERF.md §6).  Each term is a load of the bag's id
// followed by a dependent load of the row.
//
// Design:
//   * Two round trips a thread, not 2 * hot: a thread loads all hot ids,
//     weights and mask bytes of its bag first (as int4 / float4 / 32-bit
//     words where hot % 4 == 0 and the three arrays are aligned, scalar
//     loads otherwise), clips the ids and folds the mask into the weights;
//     then issues all hot row loads; then adds.  hot is a template
//     parameter for 1, 2, 4, 8, 16 and 32; any other hot runs in chunks of
//     8 slots, each chunk's loads issued together.
//   * Two layouts, picked per call by the wrapper: one thread per (bag,
//     column pair) with float2 row loads and stores where dim is even and
//     the table is 8-byte aligned (half the threads and load instructions
//     for the same bytes; the faster at serve_bulk), else one thread per
//     (bag, column).  The bag's threads are neighbours, so a row's columns
//     are read by one instruction and the output is stored coalesced.
//   * 128 threads a block: of 64 to 1,024, the fastest at serve_bulk warm
//     and within noise of the fastest cold.
//   * The wrapper's elementwise passes (ones, w * mask, the clamp) are
//     folded in: nothing is written before the kernel runs.
//
// Arithmetic: the weight is w * (mask ? 1.0f : 0.0f), a rounded product as
// `weights * mask.to(float32)` computes it (NaN and inf weights stay NaN
// behind a zero mask).  The hot terms are added in serial order from 0.0
// with explicit round-to-nearest multiply and add (__fmul_rn / __fadd_rn),
// as the Pallas kernel's revisited output block adds them; nvcc would
// otherwise contract the pair into an FMA, and the plain version's serial
// loop would no longer match bit for bit.  Zero-weight slots are not
// skipped: inf * 0 gives NaN, as in JAX.
//
// Offsets: id * dim and the flat output index are computed in 64 bits (a
// 50M x 256 table holds 1.28e10 elements).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 8;     // slots per chunk when hot is not a template

// Slots [i0, i0 + n) of one bag, clipped ids and folded weights; slots at
// or past hot are left unset.  vec: hot % 4 == 0 and ib, wb (16 bytes) and
// mb (4 bytes) aligned, so every group of 4 slots is whole.
template <int n>
__device__ __forceinline__ void load_slots(const int* __restrict__ ib,
                                           const float* __restrict__ wb,
                                           const uint8_t* __restrict__ mb,
                                           int i0, int hot, int V, bool vec,
                                           int* id, float* wt) {
  bool on[n];
  if (n % 4 == 0 && vec) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const int j = 4 * q;
      if (i0 + j >= hot) continue;
      const int4 iv = __ldg(reinterpret_cast<const int4*>(ib + i0 + j));
      id[j] = iv.x; id[j + 1] = iv.y; id[j + 2] = iv.z; id[j + 3] = iv.w;
      if (wb) {
        const float4 fv = __ldg(reinterpret_cast<const float4*>(wb + i0 + j));
        wt[j] = fv.x; wt[j + 1] = fv.y; wt[j + 2] = fv.z; wt[j + 3] = fv.w;
      } else {
        wt[j] = wt[j + 1] = wt[j + 2] = wt[j + 3] = 1.0f;
      }
      if (mb) {
        const uint32_t m = __ldg(reinterpret_cast<const unsigned*>(
            mb + i0 + j));
#pragma unroll
        for (int k = 0; k < 4; ++k) on[j + k] = (m >> (8 * k)) & 0xffu;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      if (i0 + j >= hot) continue;
      id[j] = __ldg(ib + i0 + j);
      wt[j] = wb ? __ldg(wb + i0 + j) : 1.0f;
      if (mb) on[j] = __ldg(mb + i0 + j);
    }
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j >= hot) continue;
    id[j] = min(max(id[j], 0), V - 1);
    if (mb) wt[j] = __fmul_rn(wt[j], on[j] ? 1.0f : 0.0f);
  }
}

// The sum over slots [i0, i0 + n) into acc, in order: all n row loads
// first, then the adds.  P columns per thread (1, or 2 as a float2).
template <int n, int P>
__device__ __forceinline__ void add_slots(const float* __restrict__ table,
                                          int dim, int d, int i0, int hot,
                                          const int* id, const float* wt,
                                          float* acc) {
  float v[n][P];
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j >= hot) continue;
    const float* row = table + (int64_t)id[j] * dim + d;
    if constexpr (P == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(row));
      v[j][0] = t.x;
      v[j][1] = t.y;
    } else {
      v[j][0] = __ldg(row);
    }
  }
#pragma unroll
  for (int j = 0; j < n; ++j) {
    if (i0 + j >= hot) continue;
#pragma unroll
    for (int p = 0; p < P; ++p)
      acc[p] = __fadd_rn(acc[p], __fmul_rn(v[j][p], wt[j]));
  }
}

// HOT > 0: exactly HOT slots a bag, unrolled; HOT == 0: hot in chunks.
template <int HOT, int P>
__global__ void __launch_bounds__(THREADS)
embedding_bag_kernel(const float* __restrict__ table,
                     const int* __restrict__ idx, const float* __restrict__ w,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ out, int64_t n_threads, int V,
                     int hot_rt, int dim, int vec) {
  const int hot = HOT > 0 ? HOT : hot_rt;
  const int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (o >= n_threads) return;
  const int per_bag = dim / P;
  int64_t b;
  int d;
  if (n_threads <= 0xffffffffll) {   // 32-bit division where it fits
    const uint32_t o32 = (uint32_t)o;
    b = o32 / (uint32_t)per_bag;
    d = (int)(o32 - (uint32_t)b * per_bag) * P;
  } else {
    b = o / per_bag;
    d = (int)(o - b * per_bag) * P;
  }
  const int* ib = idx + b * hot;
  const float* wb = w ? w + b * hot : nullptr;
  const uint8_t* mb = mask ? mask + b * hot : nullptr;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  if constexpr (HOT > 0) {
    int id[HOT];
    float wt[HOT];
    load_slots<HOT>(ib, wb, mb, 0, hot, V, vec, id, wt);
    add_slots<HOT, P>(table, dim, d, 0, hot, id, wt, acc);
  } else {
    for (int i0 = 0; i0 < hot; i0 += CHUNK) {
      int id[CHUNK];
      float wt[CHUNK];
      load_slots<CHUNK>(ib, wb, mb, i0, hot, V, vec, id, wt);
      add_slots<CHUNK, P>(table, dim, d, i0, hot, id, wt, acc);
    }
  }
  float* ob = out + b * dim + d;
  if constexpr (P == 2) {
    *reinterpret_cast<float2*>(ob) = make_float2(acc[0], acc[1]);
  } else {
    *ob = acc[0];
  }
}

template <int P>
int launch(const float* table, const int* idx, const float* w,
           const uint8_t* mask, float* out, int V, int n_bags, int hot,
           int dim, int vec, cudaStream_t stream) {
  const int64_t n_threads = (int64_t)n_bags * (dim / P);
  const unsigned blocks = (unsigned)((n_threads + THREADS - 1) / THREADS);
#define BAG_CASE(H)                                                        \
  embedding_bag_kernel<H, P><<<blocks, THREADS, 0, stream>>>(              \
      table, idx, w, mask, out, n_threads, V, hot, dim, vec)
  switch (hot) {
    case 1: BAG_CASE(1); break;
    case 2: BAG_CASE(2); break;
    case 4: BAG_CASE(4); break;
    case 8: BAG_CASE(8); break;
    case 16: BAG_CASE(16); break;
    case 32: BAG_CASE(32); break;
    default: BAG_CASE(0);
  }
#undef BAG_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (V, dim) float32, V >= 1; idx (n_bags, hot) int32, any values
// (clipped here); w (n_bags, hot) float32 or null (weights of 1); mask
// (n_bags, hot) bool or null (no mask); out (n_bags, dim) float32.
// vec != 0: hot % 4 == 0, idx and w 16-byte aligned, mask 4-byte aligned.
// pairs != 0: one thread per column pair (dim even, table and out 8-byte
// aligned); else one thread per column.
extern "C" int embedding_bag_f32(const void* table, const void* idx,
                                 const void* w, const void* mask, void* out,
                                 int V, int n_bags, int hot, int dim,
                                 int vec, int pairs, void* stream) {
  auto* t = static_cast<const float*>(table);
  auto* i = static_cast<const int*>(idx);
  auto* wf = static_cast<const float*>(w);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return pairs ? launch<2>(t, i, wf, m, o, V, n_bags, hot, dim, vec, st)
               : launch<1>(t, i, wf, m, o, V, n_bags, hot, dim, vec, st);
}
