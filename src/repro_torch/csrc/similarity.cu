// Cosine-similarity product with the norm epilogue fused in.
//
// Replaces src/repro/kernels/similarity/kernel.py::similarity_pallas
// (_sim_kernel): out[q, n] = (Q[q] . R[n]) / max(qn[q] * rn[n], 1e-12).
//
// What bounds it on an H100: the product does 2 * nq * n * m fp32
// operations on the CUDA cores (67 TFLOP/s; no tensor cores, see below)
// and reads R once (4 * n * m bytes at 3.35 TB/s).  Against the
// 32,832 x 58,541 Douban-width arena that is 3.67 ms of operations
// against 2.30 ms of bytes at nq = 64, and 1.84 ms against 2.30 ms at
// nq = 32, the server's burst: operations bound the first, bytes the
// second.
//
// Design: a pipelined SGEMM on the CUDA cores, 128 threads a block.
// - Block tile BM x 128 (rows of Q x rows of R), BM = 64 or 32, one entry
//   point per BM: at the burst's nq = 32 a 64-row tile would spend half
//   its FMAs on zero rows.  Grid (ceil(n / 128), ceil(nq / BM)): 257
//   blocks at n = 32,832, two to an SM (__launch_bounds__(128, 2)), one
//   wave.
// - Each thread keeps an 8 x 16 register tile: rows ty + (BM / 8) x,
//   columns tx + 8 y.  A 64-row tile needs 64 such threads, a 32-row tile
//   32, so the block's 128 threads form G = 2 or 4 groups that split each
//   slice's depth between them (group g takes items g * 32 / G onwards);
//   after the last slice the groups' tiles are summed through shared
//   memory in group order.  Per depth step a thread reads 24 operands from
//   shared memory for 128 FMAs.
// - Copies: a ratings row is m * sizeof(T) bytes with m often odd, so rows
//   start on 4-byte (bf16: 2-byte) boundaries, below what TMA and 16-byte
//   cp.async need.  Each row's 32-item slice is therefore copied as the
//   16-byte-aligned chunks that cover it (9 for f32, 5 for bf16) with
//   cp.async.cg, into a row-major staging tile; item k0 + kk of a row sits
//   at its row's offset delta (the row start mod 16 bytes) + kk.  Chunks
//   past the end of the row are zero-filled (cp.async's src-size), so the
//   ragged item edge needs no padding; rows past nq or n are clamped to
//   the last row and their results never stored.  The staging row of 36
//   f32 words puts the 8 columns a warp reads at one step in distinct
//   banks whatever their deltas.  Why not 4-byte cp.async straight into
//   k-major tiles: those copies take one instruction per item, and they
//   share the SM's load/store path with the operand reads; the 16-byte
//   chunks take a quarter of the instructions (measured faster on the
//   card, PERF.md).
// - A 4-stage cp.async ring: slices t+1..t+3 are in flight while slice t
//   is multiplied, one __syncthreads per slice.  The ring takes 108 KB
//   (f32, BM = 64), 90 KB (f32, BM = 32), 60 or 50 KB (bf16) of dynamic
//   shared memory, so the launch raises the block's limit first.
// - bf16 goes through the same chunks and ring and is converted to f32 as
//   it is read from shared memory.
// ptxas (-Xptxas -v, sm_90a; printed by chip_smoke.py): f32 255 registers
// at BM = 64 and at BM = 32, bf16 247 and 254, no spills; dynamic shared
// memory as above, no static.
//
// Precision: plain fp32 fmaf, no TF32 and no tensor-core mma.  TF32 keeps
// about three decimal digits, and lists built with it would miss the 1e-6
// twin tolerance of candidate_mask.  On integer star ratings every
// partial sum is an integer below 2^24, so any summation order (the
// groups' included) is exact and the output equals the plain version's
// bit for bit.  The epilogue rounds as the plain version does (__fmul_rn,
// fmaxf, __fdiv_rn; no fast math).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // rows of R per block
constexpr int BK = 32;             // items per slice
constexpr int TM = 8, TN = 16;     // register tile
constexpr int TX = BN / TN;        // thread columns of a group
constexpr int THREADS = 128;
constexpr int STAGES = 4;
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int BM>
struct Tile {
  static constexpr int V = 16 / sizeof(T);           // items per chunk
  static constexpr int CH = BK / V + 1;              // chunks per row
  static constexpr int LDK = CH * V;                 // staging row, items
  static constexpr int ROWS = BM + BN;               // Q's rows, then R's
  static constexpr int CHUNKS = ROWS * CH;           // per slice
  static constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr int STAGE = ROWS * LDK;           // items
  static constexpr int SMEM = STAGES * STAGE * sizeof(T);
  static constexpr int GT = (BM / TM) * TX;          // threads per group
  static constexpr int G = THREADS / GT;             // groups
  static constexpr int KG = BK / G;                  // items per group
  static_assert(G * GT == THREADS && KG * G == BK, "tiling");
  static_assert((G - 1) * BM * BN * sizeof(float) <= SMEM,
                "the groups' partial tiles fit in the ring");
};

// 16-byte copy global -> shared; the L2 fetches 256 bytes around it.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
               ::"r"(dst), "l"(src) : "memory");
}

// Copies the first n of the 16 bytes; the rest is zero-filled.
__device__ __forceinline__ void cp_async16_fill(uint32_t dst, const void* src,
                                                int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ const T* align16(const T* p) {
  return reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(p) &
                                    ~uintptr_t(15));
}

// Items between a row's start and the 16-byte boundary below it.
template <typename T>
__device__ __forceinline__ int delta(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Staging row `row` of a block: Q's rows first, then R's, each clamped to
// the last row of its matrix.
template <typename T, int BM>
__device__ __forceinline__ const T* stage_row(const T* Q, const T* R, int row,
                                              int q0, int nq, int n0, int n,
                                              int m) {
  return row < BM ? Q + (int64_t)min(q0 + row, nq - 1) * m
                  : R + (int64_t)min(n0 + row - BM, n - 1) * m;
}

// The chunks of slice t that this thread copies: e = tid + THREADS * i,
// chunk e % CH of staging row e / CH, into byte 16 e of the stage.
template <typename T, int BM>
__device__ __forceinline__ void copy_slice(uint32_t dst, const T* Q,
                                           const T* R, int t, int q0, int nq,
                                           int n0, int n, int m) {
  using Tl = Tile<T, BM>;
  const int k0 = t * BK;
  if (k0 + Tl::LDK <= m) {                // no chunk passes a row's end
#pragma unroll
    for (int i = 0; i < Tl::PER; ++i) {
      const int e = threadIdx.x + THREADS * i;
      if (Tl::CHUNKS % THREADS == 0 || e < Tl::CHUNKS) {
        const T* rs = stage_row<T, BM>(Q, R, e / Tl::CH, q0, nq, n0, n, m);
        cp_async16(dst + 16u * e, align16(rs) + Tl::V * (e % Tl::CH) + k0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < Tl::PER; ++i) {
      const int e = threadIdx.x + THREADS * i;
      if (Tl::CHUNKS % THREADS == 0 || e < Tl::CHUNKS) {
        const int c = e % Tl::CH;
        const T* rs = stage_row<T, BM>(Q, R, e / Tl::CH, q0, nq, n0, n, m);
        const int first = k0 + Tl::V * c - delta(rs);   // the chunk's item
        const int valid = max(0, min(Tl::V, m - first));
        cp_async16_fill(dst + 16u * e,
                        valid ? align16(rs) + Tl::V * c + k0 : rs,
                        valid * static_cast<int>(sizeof(T)));
      }
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(THREADS, 2)
cosine_kernel(const T* __restrict__ Q, const T* __restrict__ R,
              const float* __restrict__ qn, const float* __restrict__ rn,
              float* __restrict__ out, int nq, int n, int m) {
  using Tl = Tile<T, BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* smem = reinterpret_cast<const T*>(smem_raw);
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int g = tid / Tl::GT, i = tid % Tl::GT;
  const int tx = i % TX, ty = i / TX;

  // Where this thread's operands sit in a stage: row * LDK + delta, from
  // its group's first item.
  int ao[TM], bo[TN];
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int row = ty + (BM / TM) * x;
    ao[x] = row * Tl::LDK + g * Tl::KG +
            delta(stage_row<T, BM>(Q, R, row, q0, nq, n0, n, m));
  }
#pragma unroll
  for (int y = 0; y < TN; ++y) {
    const int row = BM + tx + TX * y;
    bo[y] = row * Tl::LDK + g * Tl::KG +
            delta(stage_row<T, BM>(Q, R, row, q0, nq, n0, n, m));
  }

  float acc[TM][TN];
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TN; ++y) acc[x][y] = 0.f;

  const int slices = (m + BK - 1) / BK;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < slices)
      copy_slice<T, BM>(s0 + (t % STAGES) * Tl::STAGE * sizeof(T), Q, R, t,
                        q0, nq, n0, n, m);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    cp_async_wait<STAGES - 2>();      // slice t has landed (this thread's)
    __syncthreads();                  // everyone's; stage t-1 is free
    const int tn = t + STAGES - 1;
    if (tn < slices)
      copy_slice<T, BM>(s0 + (tn % STAGES) * Tl::STAGE * sizeof(T), Q, R, tn,
                        q0, nq, n0, n, m);
    cp_async_commit();
    const T* st = smem + (t % STAGES) * Tl::STAGE;
#pragma unroll 4
    for (int kk = 0; kk < Tl::KG; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int x = 0; x < TM; ++x) a[x] = to_float(st[ao[x] + kk]);
#pragma unroll
      for (int y = 0; y < TN; ++y) b[y] = to_float(st[bo[y] + kk]);
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
    }
  }

  if constexpr (Tl::G > 1) {
    // Groups 1..G-1 hand their tiles to group 0, which adds them in order.
    cp_async_wait<0>();
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem_raw);
    if (g > 0) {
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y)
          part[(((g - 1) * TM + x) * TN + y) * Tl::GT + i] = acc[x][y];
    }
    __syncthreads();
    if (g > 0) return;
#pragma unroll 1
    for (int h = 1; h < Tl::G; ++h)
#pragma unroll
      for (int x = 0; x < TM; ++x)
#pragma unroll
        for (int y = 0; y < TN; ++y)
          acc[x][y] += part[(((h - 1) * TM + x) * TN + y) * Tl::GT + i];
  }

  float r[TN];
  int col[TN];
#pragma unroll
  for (int y = 0; y < TN; ++y) {
    col[y] = n0 + tx + TX * y;
    r[y] = col[y] < n ? rn[col[y]] : 1.f;
  }
#pragma unroll
  for (int x = 0; x < TM; ++x) {
    const int q = q0 + ty + (BM / TM) * x;
    if (q >= nq) continue;
    const float a = qn[q];
    float* orow = out + (int64_t)q * n;
#pragma unroll
    for (int y = 0; y < TN; ++y) {
      if (col[y] < n) {
        const float denom = fmaxf(__fmul_rn(a, r[y]), EPS);
        orow[col[y]] = __fdiv_rn(acc[x][y], denom);
      }
    }
  }
}

template <typename T, int BM>
int launch(const void* Q, const void* R, const void* qn, const void* rn,
           void* out, int nq, int n, int m, void* stream) {
  auto* kernel = cosine_kernel<T, BM>;
  constexpr int smem = Tile<T, BM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Two blocks per SM need the largest shared-memory carveout.
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Q), static_cast<const T*>(R),
      static_cast<const float*>(qn), static_cast<const float*>(rn),
      static_cast<float*>(out), nq, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q (nq, m), R (n, m) row-major and contiguous; qn (nq,), rn (n,) already
// clamped to >= EPS by the wrapper; out (nq, n) float32.  The _bm32 entry
// points take nq <= 32 best (one 32-row tile), the _bm64 ones larger nq;
// both compute the same function for any nq.
#define COSINE_ENTRY(NAME, T, BM)                                           \
  extern "C" int NAME(const void* Q, const void* R, const void* qn,         \
                      const void* rn, void* out, int nq, int n, int m,      \
                      void* stream) {                                       \
    return launch<T, BM>(Q, R, qn, rn, out, nq, n, m, stream);             \
  }

COSINE_ENTRY(cosine_similarity_f32_bm32, float, 32)
COSINE_ENTRY(cosine_similarity_f32_bm64, float, 64)
COSINE_ENTRY(cosine_similarity_bf16_bm32, __nv_bfloat16, 32)
COSINE_ENTRY(cosine_similarity_bf16_bm64, __nv_bfloat16, 64)
