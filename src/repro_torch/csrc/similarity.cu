// Cosine-similarity product with the norm epilogue fused in.
//
// Replaces src/repro/kernels/similarity/kernel.py::similarity_pallas
// (_sim_kernel): out[q, n] = (Q[q] . R[n]) / max(qn[q] * rn[n], 1e-12).
// One route per operand type.  Both sum in fp32 and round the epilogue as
// the plain version does (__fmul_rn, fmaxf, __fdiv_rn; no fast math).
//
// ===== bf16: TMA + wgmma on the tensor cores (cosine_similarity_bf16_wgmma)
//
// What bounds it on an H100: 2 * nq * n * m operations at the tensor
// cores' bf16 rate (989 TFLOP/s), against one read of Q and R (2 bytes an
// item) and one write of the f32 block at 3.35 TB/s.  models/cf.build_step's
// 32,768^2 x 58,541 product is 127.1 ms of operations against 3.6 ms of
// bytes; 32 or 64 rows of Q against the 32,832 x 58,541 arena are bound by
// the 3.84 GB read of R (1.15 ms).
//
// Precision: a bf16 x bf16 product is exact in fp32 and wgmma sums in
// fp32, so the TF32 argument of the f32 route (below) does not apply; only
// the order of the sums differs from the plain version.  On integer
// ratings every partial sum is an integer below 2^24, exact in any order,
// and the output equals the plain version's bit for bit.
//
// Design (right and simple first; a persistent grid, setmaxnreg, clusters
// and TMA multicast are left for later):
// - Block tile BM x BN = 128 x 256 rows of Q x rows of R, K step 64
//   items: one 128-byte swizzle row.  A 128 x 256 tile does 85 operations
//   for each byte it reads from L2, a 128 x 128 tile 64, and with no
//   multicast the L2's read rate is what holds the build back; a 128 x 128
//   tile measured slower on the card at every shape timed (PERF.md).  One
//   block per tile, numbered in groups of 16 Q tiles walked Q first, so the
//   blocks in flight at once (one per SM) read about 16 Q tiles and 9 R
//   tiles, which share L2.
// - 288 threads: two consumer warpgroups (threads 0-255), each owning 64
//   rows of Q, and one producer warp whose lane 0 issues the TMA loads.
// - Loads: one 2-D tensor map per operand (bf16, dims {m, rows}, row
//   stride ld * 2 bytes, box 64 items x 128 (Q) or 256 (R) rows, 128-byte
//   swizzle), encoded on the host at each launch through the driver entry
//   point that cudaGetDriverEntryPoint returns (no -lcuda).  The hardware
//   zero-fills the box past m and past nq or n, so the ragged edges need no
//   padding.  TMA needs a 16-byte-aligned base and row stride: the wrapper
//   checks them (kernel.py), ops.py copies an unaligned input, and
//   models/cf.build_step writes its rows into an aligned buffer.
// - A 4-stage ring with a full and an empty mbarrier per stage.  The
//   producer waits until a stage is empty, arms its full barrier with the
//   stage's bytes and issues both loads.  A consumer warpgroup waits until
//   the stage is full, issues its 4 k16 steps of two
//   wgmma.m64n128k16 each (A and B from shared memory, both K-major: Q.R^T
//   needs no transpose), commits them, waits until only this group is in
//   flight and frees the previous stage (its 128 threads arrive).
// - fp32 accumulators in registers; the epilogue divides by the norms and
//   stores with a mask at nq and n, at int64 offsets.
// - Dynamic shared memory: 4 stages of 16 + 32 KB, 64 bytes of barriers
//   and 1 KB of alignment slack, 197,696 bytes; one block per SM.
// - Every tile is computed, also when Q is R: the work is the 2 nq n m
//   that kernel.cost counts.  At nq <= 64 the second warpgroup multiplies
//   the zeros TMA filled in past nq; no branch spares it, because a
//   product on a path the compiler cannot prove uniform per warpgroup is
//   serialised (ptxas C7518), and such calls are bound by the read of R.
// ptxas (-Xptxas -v, sm_90a; printed by chip_smoke.py): 154 registers, no
// spills, no static shared memory.
//
// ===== f32: a pipelined SGEMM on the CUDA cores (cosine_similarity_f32_*)
//
// What bounds it on an H100: the product does 2 * nq * n * m fp32
// operations on the CUDA cores (67 TFLOP/s; no tensor cores, see below)
// and reads R once (4 * n * m bytes at 3.35 TB/s).  Against the
// 32,832 x 58,541 Douban-width arena that is 3.67 ms of operations
// against 2.30 ms of bytes at nq = 64, and 1.84 ms against 2.30 ms at
// nq = 32, the server's burst: operations bound the first, bytes the
// second.
//
// Design: 128 threads a block.
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
// - Copies: a ratings row is 4 * m bytes with m often odd, so rows start
//   on 4-byte boundaries, below what TMA and 16-byte cp.async need.  Each
//   row's 32-item slice is therefore copied as the 9 16-byte-aligned
//   chunks that cover it with cp.async.cg, into a row-major staging tile;
//   item k0 + kk of a row sits at its row's offset delta (the row start
//   mod 16 bytes) + kk.  Chunks past the end of the row are zero-filled
//   (cp.async's src-size), so the ragged item edge needs no padding; rows
//   past nq or n are clamped to the last row and their results never
//   stored.  The staging row of 36 words puts the 8 columns a warp reads
//   at one step in distinct banks whatever their deltas.  Why not 4-byte
//   cp.async straight into k-major tiles: those copies take one
//   instruction per item, and they share the SM's load/store path with
//   the operand reads; the 16-byte chunks take a quarter of the
//   instructions (measured faster on the card, PERF.md).
// - A 4-stage cp.async ring: slices t+1..t+3 are in flight while slice t
//   is multiplied, one __syncthreads per slice.  The ring takes 108 KB
//   (BM = 64) or 90 KB (BM = 32) of dynamic shared memory, so the launch
//   raises the block's limit first.
// ptxas (-Xptxas -v, sm_90a; printed by chip_smoke.py): 255 registers at
// BM = 64 and at BM = 32, no spills; dynamic shared memory as above, no
// static.
//
// Precision: plain fp32 fmaf, no TF32 and no tensor-core mma.  TF32 keeps
// about three decimal digits, and lists built with it would miss the 1e-6
// twin tolerance of candidate_mask.  On integer star ratings every
// partial sum is an integer below 2^24, so any summation order (the
// groups' included) is exact and the output equals the plain version's
// bit for bit.
#include <cuda.h>            // CUtensorMap and its enums; no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // rows of R per block
constexpr int BK = 32;             // items per slice
constexpr int TM = 8, TN = 16;     // register tile
constexpr int TX = BN / TN;        // thread columns of a group
constexpr int THREADS = 128;
constexpr int STAGES = 4;
constexpr float EPS = 1e-12f;

template <int BM>
struct Tile {
  static constexpr int V = 16 / sizeof(float);       // items per chunk
  static constexpr int CH = BK / V + 1;              // chunks per row
  static constexpr int LDK = CH * V;                 // staging row, items
  static constexpr int ROWS = BM + BN;               // Q's rows, then R's
  static constexpr int CHUNKS = ROWS * CH;           // per slice
  static constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;
  static constexpr int STAGE = ROWS * LDK;           // items
  static constexpr int SMEM = STAGES * STAGE * sizeof(float);
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

__device__ __forceinline__ const float* align16(const float* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) &
                                        ~uintptr_t(15));
}

// Items between a row's start and the 16-byte boundary below it.
__device__ __forceinline__ int delta(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) /
                          sizeof(float));
}

// Staging row `row` of a block: Q's rows first, then R's, each clamped to
// the last row of its matrix.
template <int BM>
__device__ __forceinline__ const float* stage_row(const float* Q,
                                                  const float* R, int row,
                                                  int q0, int nq, int n0,
                                                  int n, int m) {
  return row < BM ? Q + (int64_t)min(q0 + row, nq - 1) * m
                  : R + (int64_t)min(n0 + row - BM, n - 1) * m;
}

// The chunks of slice t that this thread copies: e = tid + THREADS * i,
// chunk e % CH of staging row e / CH, into byte 16 e of the stage.
template <int BM>
__device__ __forceinline__ void copy_slice(uint32_t dst, const float* Q,
                                           const float* R, int t, int q0,
                                           int nq, int n0, int n, int m) {
  using Tl = Tile<BM>;
  const int k0 = t * BK;
  if (k0 + Tl::LDK <= m) {                // no chunk passes a row's end
#pragma unroll
    for (int i = 0; i < Tl::PER; ++i) {
      const int e = threadIdx.x + THREADS * i;
      if (Tl::CHUNKS % THREADS == 0 || e < Tl::CHUNKS) {
        const float* rs = stage_row<BM>(Q, R, e / Tl::CH, q0, nq, n0, n, m);
        cp_async16(dst + 16u * e, align16(rs) + Tl::V * (e % Tl::CH) + k0);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < Tl::PER; ++i) {
      const int e = threadIdx.x + THREADS * i;
      if (Tl::CHUNKS % THREADS == 0 || e < Tl::CHUNKS) {
        const int c = e % Tl::CH;
        const float* rs = stage_row<BM>(Q, R, e / Tl::CH, q0, nq, n0, n, m);
        const int first = k0 + Tl::V * c - delta(rs);   // the chunk's item
        const int valid = max(0, min(Tl::V, m - first));
        cp_async16_fill(dst + 16u * e,
                        valid ? align16(rs) + Tl::V * c + k0 : rs,
                        valid * static_cast<int>(sizeof(float)));
      }
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(THREADS, 2)
cosine_kernel(const float* __restrict__ Q, const float* __restrict__ R,
              const float* __restrict__ qn, const float* __restrict__ rn,
              float* __restrict__ out, int nq, int n, int m) {
  using Tl = Tile<BM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float* smem = reinterpret_cast<const float*>(smem_raw);
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
            delta(stage_row<BM>(Q, R, row, q0, nq, n0, n, m));
  }
#pragma unroll
  for (int y = 0; y < TN; ++y) {
    const int row = BM + tx + TX * y;
    bo[y] = row * Tl::LDK + g * Tl::KG +
            delta(stage_row<BM>(Q, R, row, q0, nq, n0, n, m));
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
      copy_slice<BM>(s0 + (t % STAGES) * Tl::STAGE * sizeof(float), Q, R, t,
                     q0, nq, n0, n, m);
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    cp_async_wait<STAGES - 2>();      // slice t has landed (this thread's)
    __syncthreads();                  // everyone's; stage t-1 is free
    const int tn = t + STAGES - 1;
    if (tn < slices)
      copy_slice<BM>(s0 + (tn % STAGES) * Tl::STAGE * sizeof(float), Q, R,
                     tn, q0, nq, n0, n, m);
    cp_async_commit();
    const float* st = smem + (t % STAGES) * Tl::STAGE;
#pragma unroll 4
    for (int kk = 0; kk < Tl::KG; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int x = 0; x < TM; ++x) a[x] = st[ao[x] + kk];
#pragma unroll
      for (int y = 0; y < TN; ++y) b[y] = st[bo[y] + kk];
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

template <int BM>
int launch(const void* Q, const void* R, const void* qn, const void* rn,
           void* out, int nq, int n, int m, void* stream) {
  auto* kernel = cosine_kernel<BM>;
  constexpr int smem = Tile<BM>::SMEM;
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
      static_cast<const float*>(Q), static_cast<const float*>(R),
      static_cast<const float*>(qn), static_cast<const float*>(rn),
      static_cast<float*>(out), nq, n, m);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;                  // rows of Q: two warpgroups of 64
constexpr int BN = 256;                  // rows of R
constexpr int NB = 2;                    // m64n128k16 products per k16 step
constexpr int BK = 64;                   // items per stage: 128 bytes
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int GROUP = 16;                // Q tiles per raster group
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// The ring, then the barriers, plus room to align the ring to the 1,024
// bytes of a 128-byte swizzle pattern (8 rows).
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "swizzle atoms");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.  The loop is
// inside the asm: a C++ loop around try_wait would put the products after
// it on a path the compiler takes for divergent, and it then serialises
// them (ptxas C7518).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      ::"r"(bar), "r"(parity) : "memory");
}

// The box at item x, row y of `map` into shared memory at `dst`; the
// bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
        "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: start
// address / 16, leading offset unused (1), 8-row groups 1,024 bytes apart,
// layout 1 (128-byte swizzle).  A k16 step inside the 64-item row moves the
// start by 32 bytes; the hardware applies the swizzle to the address bits.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, this warpgroup's fragment) += A (64 x 16) . B (128 x 16)^T.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
cosine_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tr,
                    const float* __restrict__ qn,
                    const float* __restrict__ rn, float* __restrict__ out,
                    int nq, int n, int m) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t full0 = ring + STAGES * STAGE_BYTES;   // full[s] at + 8 s
  const uint32_t empty0 = full0 + STAGES * 8;

  // This block's tile: groups of GROUP Q tiles, Q tile fastest in a group.
  const int tiles_q = (nq + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int per_group = GROUP * tiles_n;
  const int bid = blockIdx.x;
  const int first = bid / per_group * GROUP;
  const int rows = min(tiles_q - first, GROUP);
  const int q0 = (first + bid % per_group % rows) * BM;
  const int n0 = bid % per_group / rows * BN;
  const int T = (m + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                 // the producer's arrival
      mbar_init(empty0 + 8 * s, CONSUMERS);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warp's index, warp-uniform as the compiler sees it (a shuffle
  // from lane 0), so that the branches on it do not count as divergent.
  const int warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  if (warp == CONSUMERS / 32) {                    // the producer warp
    if (threadIdx.x == CONSUMERS) {
      for (int t = 0; t < T; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t a = ring + s * STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * s, STAGE_BYTES);
        tma_load(a, &tq, full0 + 8 * s, t * BK, q0);
        tma_load(a + A_BYTES, &tr, full0 + 8 * s, t * BK, n0);
      }
    }
    return;
  }

  const int wg = warp / 4;                          // consumer warpgroup
  float acc[NB][64];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;

  for (int t = 0; t < T; ++t) {
    const int s = t % STAGES;
    mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
    const uint32_t a = ring + s * STAGE_BYTES + wg * 64 * BK * 2;
    const uint32_t b = ring + s * STAGE_BYTES + A_BYTES;
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_m64n128k16(acc[j], sw128_desc(a + 32 * kk),
                         sw128_desc(b + j * 128 * BK * 2 + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();                   // slice t - 1's products are done
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    if (t > 0) mbar_arrive(empty0 + 8 * ((t - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NB; ++j) fence_regs(acc[j]);

  // Fragment of m64nNk16: register i of lane l in warp w of the warpgroup
  // holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4)
  // + i % 2.
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * wg + 16 * (threadIdx.x % 128 / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = row0 + 8 * h;
    if (q >= nq) continue;
    const float a = qn[q];
    float* orow = out + static_cast<int64_t>(q) * n;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 128 * j + 8 * c + 2 * (lane % 4) + e;
          if (col < n) {
            const float denom = fmaxf(__fmul_rn(a, rn[col]), EPS);
            orow[col] = __fdiv_rn(acc[j][4 * c + 2 * h + e], denom);
          }
        }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once; null if it is not.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int NO_ENCODER = -1000;

// The tensor map of a (rows, m) bf16 matrix with row stride ld items:
// boxes of 64 items x box_rows rows, 128-byte swizzle, zeros outside.
int encode(CUtensorMap* map, const void* base, int rows, int m, int ld,
           int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return NO_ENCODER;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

int launch(const void* Q, const void* R, const void* qn, const void* rn,
           void* out, int nq, int n, int m, int ldq, int ldr, void* stream) {
  CUtensorMap tq{}, tr{};
  if (m > 0) {                        // m = 0 issues no load
    int rc = encode(&tq, Q, nq, m, ldq, BM);
    if (rc != 0) return rc;
    rc = encode(&tr, R, n, m, ldr, BN);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cosine_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = ((nq + BM - 1) / BM) * ((n + BN - 1) / BN);
  cosine_wgmma_kernel<<<grid, THREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      tq, tr, static_cast<const float*>(qn), static_cast<const float*>(rn),
      static_cast<float*>(out), nq, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Q (nq, m), R (n, m) row-major and contiguous; qn (nq,), rn (n,) already
// clamped to >= EPS by the wrapper; out (nq, n) float32.  The _bm32 entry
// points take nq <= 32 best (one 32-row tile), the _bm64 ones larger nq;
// both compute the same function for any nq.
#define COSINE_ENTRY(NAME, BM)                                              \
  extern "C" int NAME(const void* Q, const void* R, const void* qn,         \
                      const void* rn, void* out, int nq, int n, int m,      \
                      void* stream) {                                       \
    return launch<BM>(Q, R, qn, rn, out, nq, n, m, stream);                \
  }

COSINE_ENTRY(cosine_similarity_f32_bm32, 32)
COSINE_ENTRY(cosine_similarity_f32_bm64, 64)

// Q (nq, m) and R (n, m) bf16 with unit item stride, row strides ldq and
// ldr items (multiples of 8) and 16-byte-aligned bases; qn, rn and out as
// above.  Returns a cudaError_t, or -(CUresult) if a tensor map could not
// be encoded, or -1000 if the driver has no cuTensorMapEncodeTiled.
extern "C" int cosine_similarity_bf16_wgmma(const void* Q, const void* R,
                                            const void* qn, const void* rn,
                                            void* out, int nq, int n, int m,
                                            int ldq, int ldr, void* stream) {
  return tc::launch(Q, R, qn, rn, out, nq, n, m, ldq, ldr, stream);
}
