// Tiled shared-memory GEMM building blocks shared by the fused kernels.
//
// Row-major operands, any leading dimension, ragged edges masked in the
// kernel (no padding of the operands).  One block of 256 threads owns a
// 64 x 64 output tile; each thread keeps a 4 x 4 register sub-tile whose
// rows are ty + 16*i and columns tx + 16*j, so the shared-memory reads of a
// warp are broadcasts (A) or 16 consecutive words (B) and the global stores
// of the epilogue are coalesced.  Products use FMA in the working precision
// (double or float; no tensor cores, no TF32).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rp {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TDIM = 16;                 // threads per tile row / column
constexpr int NTHREADS = TDIM * TDIM;    // 256

__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <typename T>
struct Tiles {
  T a[BK][BM + 1];  // A tile stored k-major (transposed); +1 spreads banks
  T b[BK][BN];
};

// acc += A[row0:row0+BM, 0:K] @ B[0:K, col0:col0+BN]; rows >= M, columns
// >= N and depth >= K read as zero.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ void tile_mma(Tiles<T>& sm, T (&acc)[TM][TN],
                                         const T* __restrict__ A, int lda,
                                         const T* __restrict__ B, int ldb,
                                         int M, int N, int K, int row0, int col0) {
  const int tid = threadIdx.x;
  const int tx = tid % TDIM;
  const int ty = tid / TDIM;
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / NTHREADS; ++i) {
      const int e = tid + i * NTHREADS;
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      sm.a[c][r] = (gr < M && gc < K) ? A[(size_t)gr * lda + gc] : T(0);
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / NTHREADS; ++i) {
      const int e = tid + i * NTHREADS;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      sm.b[r][c] = (gr < K && gc < N) ? B[(size_t)gr * ldb + gc] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.a[k][ty + TDIM * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.b[k][tx + TDIM * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmadd(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace rp
