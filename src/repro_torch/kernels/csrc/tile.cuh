// Shared-memory tile helpers for the f32 SIMT kernels.
//
// Both f32 kernels hold their operand tiles in shared memory with every
// extent rounded up to a multiple of 4 (zero-filled past the real edge), so
// the 4x4 register micro-tile below needs no predicates and every operand
// read is one 16-byte vector load.  Products are plain IEEE f32 FMAs (no
// TF32, no tensor cores), so f32 inputs keep full precision.
#pragma once

#include <cuda_runtime.h>

namespace tcm {

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Four consecutive elements; p must be aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Copy a rows x cols tile (row stride ld, in elements) from global memory
// into shared memory laid out [rows4][cols4], zero past the real edge.
// Consecutive threads read consecutive columns, so the reads coalesce.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int rows, int cols,
                                          int rows4, int cols4) {
  for (int i = threadIdx.x; i < rows4 * cols4; i += blockDim.x) {
    const int r = i / cols4, c = i - r * cols4;
    dst[i] = (r < rows && c < cols) ? src[r * ld + c] : 0.f;
  }
}

// C[m][n] = (accumulate ? C[m][n] * scale[m] : 0) + sum_k A(m, k) * B[k][n]
// over an m4 x n4 block of C (row stride ldc), k4 terms, with
// A(m, k) = A[k * lda + m] when A_T else A[m * lda + k] and B[k * ldb + n].
// m4, n4, k4 and the leading dimensions are multiples of 4.  Each thread
// owns 4x4 micro-tiles of C in registers and sums k in order, one FMA per
// term.  ``scale`` may be null (no rescale).
template <bool A_T>
__device__ __forceinline__ void mm_acc(const float* A, int lda, const float* B,
                                       int ldb, float* C, int ldc, int m4,
                                       int n4, int k4, const float* scale,
                                       bool accumulate) {
  const int tn = n4 >> 2;
  const int tiles = (m4 >> 2) * tn;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int m0 = (t / tn) << 2, n0 = (t % tn) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (accumulate) {
        const float4 c = *reinterpret_cast<const float4*>(&C[(m0 + i) * ldc + n0]);
        const float s = scale ? scale[m0 + i] : 1.f;
        acc[i][0] = c.x * s;
        acc[i][1] = c.y * s;
        acc[i][2] = c.z * s;
        acc[i][3] = c.w * s;
      } else {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      }
    }
#pragma unroll 2
    for (int k = 0; k < k4; k += 4) {
      float a[4][4];  // a[i][kk] = A(m0 + i, k + kk)
      if (A_T) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = load4(A + (k + kk) * lda + m0);
          a[0][kk] = v.x;
          a[1][kk] = v.y;
          a[2][kk] = v.z;
          a[3][kk] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = load4(A + (m0 + i) * lda + k);
          a[i][0] = v.x;
          a[i][1] = v.y;
          a[i][2] = v.z;
          a[i][3] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = load4(B + (k + kk) * ldb + n0);
        const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&C[(m0 + i) * ldc + n0]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace tcm
