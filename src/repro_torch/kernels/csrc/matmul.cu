// Tiled matmul Z[M,N] = A[M,K] @ B[K,N] for Hopper (sm_90a), f32 or bf16.
//
// Replaces: the Pallas TPU kernel _matmul_kernel / matmul_pallas
// (src/repro/kernels/matmul.py).  Same contract: tiles (bm, bk, bn) come
// from the TCM mapper (repro_torch/core/autotile.py), must divide the
// shapes (the caller pads), an f32 accumulator is zeroed before the first
// k step, and the output is cast back to the input dtype.
//
// What bounds it here: at the model's shapes a matmul has hundreds of
// operations per byte, so the card's bound is its tensor-core rate.  This
// first version does not reach it: it multiplies with IEEE f32 FMAs on the
// SIMT cores (f32 must not silently become TF32; bf16 is widened exactly),
// so it is bound by the FMA rate and the shared-memory reads that feed it.
//
// Design: one block of 256 threads per (bm, bn) output tile, a 2-D grid
// over output tiles (n on x, m on y), the K loop inside the block.  Each k
// step stages one bm x bk tile of A and one bk x bn tile of B in shared
// memory (one stage); the f32 accumulator tile lives in shared memory too,
// as the mapper's SMEM level counts it, and each thread sums 4x4
// micro-tiles of it in registers across the step.  Shared memory per block
// is (bm*bk + bk*bn) * sizeof(T) + bm*bn*4 bytes (extents rounded up to 4),
// checked against the 227 KB limit before launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ Z, int M, int K, int N, int bm, int bk,
                  int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bm4 = tcm::round4(bm), bk4 = tcm::round4(bk),
            bn4 = tcm::round4(bn);
  T* As = reinterpret_cast<T*>(smem);  // [bm4][bk4]
  T* Bs = As + bm4 * bk4;              // [bk4][bn4]
  float* acc = reinterpret_cast<float*>(Bs + bk4 * bn4);  // [bm4][bn4]

  const long long m0 = (long long)blockIdx.y * bm;
  const long long n0 = (long long)blockIdx.x * bn;
  for (int i = threadIdx.x; i < bm4 * bn4; i += blockDim.x) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    __syncthreads();  // the previous step's reads of As/Bs are done
    tcm::load_tile(As, A + m0 * K + k0, K, bm, bk, bm4, bk4);
    tcm::load_tile(Bs, B + (long long)k0 * N + n0, N, bk, bn, bk4, bn4);
    __syncthreads();
    tcm::mm_acc<false>(As, bk4, Bs, bn4, acc, bn4, bm4, bn4, bk4, nullptr,
                       true);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bm * bn; i += blockDim.x) {
    const int r = i / bn, c = i - r * bn;
    Z[(m0 + r) * N + n0 + c] = tcm::from_f32<T>(acc[r * bn4 + c]);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* z, int M, int K,
                   int N, int bm, int bk, int bn, cudaStream_t stream) {
  const int bm4 = tcm::round4(bm), bk4 = tcm::round4(bk),
            bn4 = tcm::round4(bn);
  const size_t smem = (size_t)(bm4 * bk4 + bk4 * bn4) * sizeof(T) +
                      (size_t)bm4 * bn4 * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(N / bn, M / bm);
  matmul_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(z),
      M, K, N, bm, bk, bn);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int tcm_matmul_launch(const void* a, const void* b, void* z, int M,
                                 int K, int N, int bm, int bk, int bn,
                                 int dtype, void* stream) {
  if (bm <= 0 || bk <= 0 || bn <= 0 || M % bm || K % bk || N % bn)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, z, M, K, N, bm, bk, bn, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, z, M, K, N, bm, bk, bn, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* tcm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
