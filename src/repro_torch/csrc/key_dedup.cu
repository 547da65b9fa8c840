// Twin dedup of a read batch's keys: for each row i, the first row j <= i
// whose key is bit for bit the same.
//
// Replaces no Pallas kernel: the JAX package dedups its read batches on
// the host (src/repro/serving/dedup.py), and so did the port.  It replaces
// the host route of serving/dedup.py::dedup_rows on the CF read path
// (CFServer.recommend_batch and predict_batch), where the keys live on the
// card: there the host copied every row's key to pageable memory (at
// Douban width 32 x 58,581 words, 7.5 MB) and hashed it with one numpy
// call per key column, whatever the batch: about 185 ms a call on an H100
// machine's host, against the 2 ms of the call's device work.  Here the
// keys are read in place and only the (B,) int32 answer goes back.
//
// The key of row i is three segments of 4-byte words, each read with its
// own row stride and unit column stride: a[i] (the top-k similarities, as
// their float32 bit patterns), b[i] (the neighbour ids), and row
// rows[i] of c (the user's rating row, gathered from the arena), or c[i]
// when rows is null (the item id of a prediction).
//
// Two launches on the caller's stream, with no sync between or inside:
//
//   probe:  hash[i] = sum over the key's words w_p of mix(w_p, p) mod 2^64,
//           mix a bijection of the 64-bit (p << 32 | w_p) (splitmix64's
//           finaliser).  The sum does not depend on the order of its
//           terms, so a row is cut into CHUNK-word pieces, one block each,
//           and the pieces meet in one 64-bit atomic add a block.
//   verify: first[i] = the smallest j <= i with hash[j] == hash[i] and an
//           identical key, compared on the raw 32-bit words (so -0.0 and
//           0.0 differ, and NaNs with other payloads differ, as
//           dedup_rows compares bytes).  One block a row walks j upward,
//           compares keys only where the hashes agree, and stops at the
//           first equal one, so the hash decides only how many keys are
//           compared, never the answer.  The hashes are an input: a test
//           can hand in colliding ones.
//
// What bounds it on an H100: latency, not bytes.  At the serving shape
// (B = 32, 58,581 words, 7 twins) the probe reads 7.5 MB and the verify
// the two keys of each compared pair (one a twin when no two distinct
// keys collide): 10.8 MB, 3.2 us at 3.35 TB/s, under one launch floor
// (5 us).  The probe spreads a row over 29 blocks with all of a thread's
// loads in flight at once; the verify compares a pair in one block, U
// word pairs a thread a step, and that one block's load latency is the
// longest part of the pair of launches (tens of us, against a read call
// of milliseconds on the host).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                // a probe block
constexpr int PER_THREAD = 8;               // words a probe thread hashes
constexpr int CHUNK = THREADS * PER_THREAD; // key words a probe block hashes
constexpr int V_THREADS = 1024;             // a verify block
constexpr int U = 8;              // word pairs a verify thread loads a step

typedef unsigned long long u64;

struct Key {
  const uint32_t* a;
  const uint32_t* b;
  const uint32_t* c;
  const int64_t* rows;            // null: row i of c
  int wa, wb;
  int64_t lda, ldb, ldc;
};

// Row i's three segments, and its word at key position p.
struct Row {
  const uint32_t* a;
  const uint32_t* b;
  const uint32_t* c;
  int wa, wab;

  __device__ __forceinline__ Row(const Key& k, int i)
      : a(k.a + (int64_t)i * k.lda), b(k.b + (int64_t)i * k.ldb),
        c(k.c + (k.rows ? k.rows[i] : (int64_t)i) * k.ldc), wa(k.wa),
        wab(k.wa + k.wb) {}

  __device__ __forceinline__ uint32_t operator[](int p) const {
    return p < wa ? a[p] : p < wab ? b[p - wa] : c[p - wab];
  }
};

__device__ __forceinline__ u64 mix(uint32_t w, uint32_t p) {
  u64 x = ((u64)p << 32) | w;
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

// grid (B, ceil(W / CHUNK)); hash zeroed before the launch.
__global__ void __launch_bounds__(THREADS)
probe_kernel(Key k, int W, u64* __restrict__ hash) {
  const int i = blockIdx.x;
  const int p0 = blockIdx.y * CHUNK;
  const int p1 = min(W, p0 + CHUNK);
  const Row row(k, i);
  uint32_t w[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {    // every load before any use
    const int p = p0 + u * THREADS + threadIdx.x;
    w[u] = p < p1 ? row[p] : 0;
  }
  u64 s = 0;
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int p = p0 + u * THREADS + threadIdx.x;
    if (p < p1) s += mix(w[u], p);
  }
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  __shared__ u64 part[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < THREADS / 32 ? part[lane] : 0;
    for (int off = THREADS / 64; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) atomicAdd(hash + i, s);
  }
}

// Whether rows i and j have the same W words; the whole block answers.
// A step loads U word pairs a thread before comparing any (a compare is
// bound by the loads' latency, one block working alone), and the block
// stops at the first step with a difference.
__device__ bool same_key(const Row& x, const Row& y, int W) {
  for (int p0 = 0; p0 < W; p0 += V_THREADS * U) {
    uint32_t a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * V_THREADS + threadIdx.x;
      a[u] = p < W ? x[p] : 0;
      b[u] = p < W ? y[p] : 0;
    }
    int diff = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) diff |= a[u] != b[u];
    if (__syncthreads_or(diff)) return false;
  }
  return true;
}

// grid (B).
__global__ void __launch_bounds__(V_THREADS)
verify_kernel(Key k, int W, const u64* __restrict__ hash,
              int* __restrict__ first) {
  const int i = blockIdx.x;
  const u64 h = hash[i];
  const Row row(k, i);
  int found = i;
  for (int j = 0; j < i; ++j) {
    if (hash[j] != h) continue;           // the same j for every thread
    if (same_key(row, Row(k, j), W)) {
      found = j;
      break;
    }
  }
  if (threadIdx.x == 0) first[i] = found;
}

Key make_key(const void* a, int wa, int lda, const void* b, int wb,
             int ldb, const void* c, const void* rows, int ldc) {
  return Key{static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
             static_cast<const uint32_t*>(c),
             static_cast<const int64_t*>(rows), wa, wb, lda, ldb, ldc};
}

}  // namespace

// a (B, wa), b (B, wb): 4-byte words at row strides lda, ldb (in words);
// c: rows of wc words at stride ldc, row rows[i] (int64, in range) for key
// i, or row i when rows is null; hash (B,) 64-bit, written.
extern "C" int key_dedup_probe(const void* a, int wa, int lda,
                               const void* b, int wb, int ldb,
                               const void* c, const void* rows, int wc,
                               int ldc, void* hash, int B,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hash, 0, sizeof(u64) * B, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int W = wa + wb + wc;
  if (W == 0) return 0;
  dim3 grid(B, (W + CHUNK - 1) / CHUNK);
  probe_kernel<<<grid, THREADS, 0, s>>>(
      make_key(a, wa, lda, b, wb, ldb, c, rows, ldc), W,
      static_cast<u64*>(hash));
  return static_cast<int>(cudaGetLastError());
}

// The same key; hash (B,) 64-bit, read; first (B,) int32, written.
extern "C" int key_dedup_verify(const void* a, int wa, int lda,
                                const void* b, int wb, int ldb,
                                const void* c, const void* rows, int wc,
                                int ldc, const void* hash, void* first,
                                int B, void* stream) {
  verify_kernel<<<B, V_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      make_key(a, wa, lda, b, wb, ldb, c, rows, ldc), wa + wb + wc,
      static_cast<const u64*>(hash), static_cast<int*>(first));
  return static_cast<int>(cudaGetLastError());
}
