// Cosine-similarity product with the norm epilogue fused in.
//
// Replaces src/repro/kernels/similarity/kernel.py::similarity_pallas
// (_sim_kernel): out[q, n] = (Q[q] . R[n]) / max(qn[q] * rn[n], 1e-12).
//
// What bounds it on an H100: at the traditional burst's shapes (nq <= 64
// new users against the whole N x m ratings arena) the product does
// 2 * nq * n * m flops in fp32 on the CUDA cores (67 TFLOP/s, no tensor
// cores) and reads R once (4 * n * m bytes at 3.35 TB/s); the two are
// within a factor of two of each other, so both matter.
//
// Design: a shared-memory tiled SGEMM.  A block owns a 64 x 64 output tile
// and walks the item axis in 32-deep slices; each of its 256 threads keeps
// a 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j) so shared-memory
// reads broadcast and output stores coalesce.  R's rows stream from device
// memory once per output-column tile; Q (small) is re-read from L2.  Global
// loads are 32 consecutive floats per warp; rows are not 16-byte aligned in
// general (m is often odd), so loads are scalar.  Ragged edges are masked in
// the kernel, so the wrapper pads nothing.
//
// Precision: plain fp32 FMA, no TF32 and no tensor-core mma.  TF32 keeps
// about three decimal digits, and lists built with it would miss the 1e-6
// twin tolerance of candidate_mask.  The epilogue divides with IEEE
// rounding (no fast math), as the plain version does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cosine_kernel(const T* __restrict__ Q, const T* __restrict__ R,
              const float* __restrict__ qn, const float* __restrict__ rn,
              float* __restrict__ out, int nq, int n, int m) {
  // +1 column of padding: the transposed store As[kk][r] from 32 lanes with
  // consecutive kk then hits 32 distinct banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / BK;
      const int kk = e % BK;
      const int gk = k0 + kk;
      const int gq = q0 + r;
      const int gn = n0 + r;
      As[kk][r] = (gq < nq && gk < m)
                      ? to_float(Q[(int64_t)gq * m + gk]) : 0.f;
      Bs[kk][r] = (gn < n && gk < m)
                      ? to_float(R[(int64_t)gn * m + gk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= nq) continue;
    const float a = qn[q];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < n) {
        const float denom = fmaxf(__fmul_rn(a, rn[c]), EPS);
        out[(int64_t)q * n + c] = __fdiv_rn(acc[i][j], denom);
      }
    }
  }
}

template <typename T>
int launch(const void* Q, const void* R, const void* qn, const void* rn,
           void* out, int nq, int n, int m, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  cosine_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(R),
      static_cast<const float*>(qn), static_cast<const float*>(rn),
      static_cast<float*>(out), nq, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q (nq, m), R (n, m) row-major and contiguous; qn (nq,), rn (n,) already
// clamped to >= EPS by the wrapper; out (nq, n) float32.
extern "C" int cosine_similarity_f32(const void* Q, const void* R,
                                     const void* qn, const void* rn,
                                     void* out, int nq, int n, int m,
                                     void* stream) {
  return launch<float>(Q, R, qn, rn, out, nq, n, m,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int cosine_similarity_bf16(const void* Q, const void* R,
                                      const void* qn, const void* rn,
                                      void* out, int nq, int n, int m,
                                      void* stream) {
  return launch<__nv_bfloat16>(Q, R, qn, rn, out, nq, n, m,
                               static_cast<cudaStream_t>(stream));
}
