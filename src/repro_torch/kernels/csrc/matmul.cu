// Tiled matmul Z[M,N] = A[M,K] @ B[K,N] for Hopper (sm_90a): bf16 through
// TMA + wgmma, f32 through SIMT FMAs.
//
// Replaces: the Pallas TPU kernel _matmul_kernel / matmul_pallas
// (src/repro/kernels/matmul.py).  Same contract: tiles (bm, bk, bn) come
// from the TCM mapper (repro_torch/core/autotile.py), must divide the
// shapes (the caller pads), an f32 accumulator is zeroed before the first
// k step, and the output is cast back to the input dtype.
//
// What bounds it here: at the model's prefill shapes a matmul does hundreds
// of operations per byte, so the card's bound is its bf16 tensor-core rate
// (989 TFLOP/s); decode (M = 1 or 8) reads each weight once and is bound by
// bytes.  Only wgmma reaches the tensor-core rate, and only if the operands
// arrive in shared memory while the previous ones are multiplied.
//
// bf16 design (wgmma_matmul): one block of three warpgroups per (bm, bn)
// output tile, m on grid x so the blocks that share a B slab run together.
//   - Warpgroup 2 is the producer: after setmaxnreg gives its registers
//     away, one thread keeps TMA loads of 64x64 boxes (128-byte rows,
//     128-byte swizzle) of A (bm x bk) and B (bk x bn) in flight into a
//     ring of up to 4 shared-memory stages (as many as fit 227 KB, at least
//     2), each guarded by a full/empty mbarrier pair.
//   - Warpgroups 0 and 1 consume: wait on a stage's full barrier, issue
//     wgmma.mma_async bf16 -> f32 from the swizzled stage through
//     descriptors (A K-major; B is row-major (K, N), so it is the MN-major
//     operand, transpose bit set), keep one wgmma group in flight and
//     release the previous stage to the producer.  The f32 accumulator
//     stays in registers for the whole K loop: each warpgroup owns half
//     the tile, at most 16384 f32 = 128 registers a thread.  bm >= 128
//     splits the tile along m (MT = bm / 128 64-row wgmma tiles each, one
//     wgmma of the whole width); bm <= 64 runs one 64-row tile (TMA
//     zero-fills rows past M, so decode's M = 1 or 8 needs no padding) and
//     splits its 64-wide column boxes between the two warpgroups.
//   - Each warpgroup's column count is a template argument, so every wgmma
//     of a stage issues without a branch; ptxas serialises wgmmas that sit
//     behind a run-time guard.
//   - The epilogue converts to bf16 and stores straight from the
//     accumulator fragment, masked at M and N.
// Instances: the (MT, N0, N1) in TCM_WGMMA_INSTANCES.  The launcher picks
// the instance and the stage count from the tile; core/autotile.py models
// the same ring (ring_stages, smem_footprint) and kernel_takes checks a
// tile before the launch.
//
// f32 design (simt_matmul_f32): wgmma on f32 is TF32, which the reference's
// 1e-3 tolerance does not allow, so f32 keeps the first port's kernel: one
// block of 256 threads per output tile, one shared-memory stage of A and B
// plus the f32 accumulator, 4x4 register micro-tiles of IEEE f32 FMAs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"
#include "tile.cuh"

namespace {

constexpr int kMaxSmem = 232448;

// ---- f32: SIMT ----------------------------------------------------------

constexpr int kSimtThreads = 256;

__global__ void __launch_bounds__(kSimtThreads)
    simt_matmul_f32(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ Z, int M, int K, int N, int bm,
                    int bk, int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bm4 = tcm::round4(bm), bk4 = tcm::round4(bk),
            bn4 = tcm::round4(bn);
  float* As = reinterpret_cast<float*>(smem);  // [bm4][bk4]
  float* Bs = As + bm4 * bk4;                  // [bk4][bn4]
  float* acc = Bs + bk4 * bn4;                 // [bm4][bn4]

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
    Z[(m0 + r) * N + n0 + c] = acc[r * bn4 + c];
  }
}

cudaError_t launch_f32(const float* a, const float* b, float* z, int M, int K,
                       int N, int bm, int bk, int bn, cudaStream_t stream) {
  const int bm4 = tcm::round4(bm), bk4 = tcm::round4(bk),
            bn4 = tcm::round4(bn);
  const size_t smem =
      sizeof(float) * ((size_t)(bm4 * bk4 + bk4 * bn4) + (size_t)bm4 * bn4);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        simt_matmul_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(N / bn, M / bm);
  simt_matmul_f32<<<grid, kSimtThreads, smem, stream>>>(a, b, z, M, K, N, bm,
                                                        bk, bn);
  return cudaGetLastError();
}

// ---- bf16: TMA + wgmma --------------------------------------------------

constexpr int kBox = 64;     // a TMA box is 64 x 64 bf16: 128-byte rows
constexpr int kRowBytes = kBox * 2;
constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kWgmmaThreads = 128 * (kConsumers + 1);
constexpr int kStages = 4;     // ring stages, fewer where they do not fit
constexpr int kBarrierBytes = 8;
constexpr int kAlign = 1024;  // the 128-byte swizzle repeats every 1024 B

// The A/B ring of a (bm, bk, bn) tile: its stage layout and stage count.
struct Ring {
  int rows, cols;        // A rows and B columns staged: bm, bn rounded to 64
  int kboxes;            // 64-deep boxes per stage
  int a_bytes, bytes;    // A's share of a stage, and the whole stage
  int stages;            // kStages, or as many as fit kMaxSmem
  __host__ __device__ Ring(int bm, int bk, int bn)
      : rows((bm + kBox - 1) / kBox * kBox),
        cols((bn + kBox - 1) / kBox * kBox),
        kboxes((bk + kBox - 1) / kBox),
        a_bytes(kboxes * rows * kRowBytes),
        bytes(kboxes * (rows + cols) * kRowBytes),
        stages((kMaxSmem - kAlign) / (bytes + 2 * kBarrierBytes)) {
    if (stages > kStages) stages = kStages;
  }
  size_t smem() const {
    return kAlign + (size_t)stages * (bytes + 2 * kBarrierBytes);
  }
};

// One consumer warpgroup: MT 64-row wgmma tiles of W columns each, from row
// row0 and column col0 of the block's tile.  It waits on each stage, runs
// its wgmmas (one group in flight), releases the previous stage and at the
// end stores its share, masked at M and N.  W = 0 is a warpgroup without
// columns (a 64-wide tile at bm <= 64): it only releases the stages.  W is
// a template argument so that every wgmma of a stage is issued without a
// branch (a run-time guard makes ptxas serialise them).
template <int MT, int W>
__device__ __forceinline__ void consume(const Ring& ring, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty,
                                        int nk, int row0, int col0,
                                        __nv_bfloat16* __restrict__ Z, int M,
                                        int N, int m0, int n0, int bm,
                                        int bn) {
  const bool lead = (threadIdx.x & 31) == 0;  // one arrival per warp
  if constexpr (W == 0) {
    for (int it = 0; it < nk; ++it) {
      const int s = it % ring.stages;
      sm90::mbar_wait(&full[s], (it / ring.stages) & 1);
      if (lead) sm90::mbar_arrive(&empty[s]);
    }
  } else {
    float acc[MT][W / 2];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc[t][i] = 0.f;

    for (int it = 0; it < nk; ++it) {
      const int s = it % ring.stages;
      sm90::mbar_wait(&full[s], (it / ring.stages) & 1);
      const uint32_t a_base = sm90::smem_u32(smem + s * ring.bytes);
      const uint32_t b_base = a_base + ring.a_bytes;
      sm90::wgmma_fence();
      for (int b = 0; b < ring.kboxes; ++b) {
#pragma unroll
        for (int kk = 0; kk < kBox / 16; ++kk) {
          // B: MN-major, 64-column groups one box (8192 B) apart, 8-row k
          // groups 1024 B apart; k16 steps 16 rows
          const uint64_t db = sm90::desc_sw128(
              b_base + (b * ring.cols + col0) * kRowBytes +
                  kk * 16 * kRowBytes,
              kBox * kRowBytes, 1024);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            // A: K-major, 8-row groups 1024 B apart; k16 steps 32 B along
            // the swizzled row
            const uint64_t da = sm90::desc_sw128(
                a_base + (b * ring.rows + row0 + 64 * t) * kRowBytes +
                    kk * 32,
                16, 1024);
            sm90::wgmma<W>(acc[t], da, db);
          }
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous stage's products are done
      if (it > 0 && lead) sm90::mbar_arrive(&empty[(it - 1) % ring.stages]);
    }
    sm90::wgmma_wait<0>();

    const int warp = (threadIdx.x & 127) / 32, lane = threadIdx.x & 31;
    const int m_end = min(M, m0 + bm), n_end = min(N, n0 + bn);
    const int cbase = n0 + col0 + 2 * (lane % 4);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int r = m0 + row0 + 64 * t + 16 * warp + lane / 4;
#pragma unroll
      for (int i = 0; i < W / 8; ++i) {
        const int col = cbase + 8 * i;
        if (col >= n_end) continue;
        if (r < m_end)
          *reinterpret_cast<__nv_bfloat162*>(Z + (long long)r * N + col) =
              __floats2bfloat162_rn(acc[t][4 * i], acc[t][4 * i + 1]);
        if (r + 8 < m_end)
          *reinterpret_cast<__nv_bfloat162*>(Z + (long long)(r + 8) * N +
                                             col) =
              __floats2bfloat162_rn(acc[t][4 * i + 2], acc[t][4 * i + 3]);
      }
    }
  }
}

// Warpgroup 0 holds N0 columns of the tile and warpgroup 1 N1: the same
// N0 = N1 = bn columns of two row halves when bm >= 128 (MT 64-row tiles
// each), or side by side the first N0 and the next N1 columns of one
// 64-row tile when bm <= 64.
template <int MT, int N0, int N1>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    wgmma_matmul(const __grid_constant__ CUtensorMap tma_a,
                 const __grid_constant__ CUtensorMap tma_b,
                 __nv_bfloat16* __restrict__ Z, int M, int N, int bm, int bk,
                 int bn, int nk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  const Ring ring(bm, bk, bn);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + ring.stages * ring.bytes);
  uint64_t* empty = full + ring.stages;
  const int m0 = blockIdx.x * bm, n0 = blockIdx.y * bn;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers * 4);  // one arrival per warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == kConsumers * 128) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % ring.stages;
        sm90::mbar_wait(&empty[s], ((it / ring.stages) & 1) ^ 1);
        unsigned char* st = smem + s * ring.bytes;
        sm90::mbar_expect_tx(&full[s], ring.bytes);
        for (int b = 0; b < ring.kboxes; ++b) {
          const int k = (it * ring.kboxes + b) * kBox;
          for (int r = 0; r < ring.rows; r += kBox)
            sm90::tma_load_2d(st + (b * ring.rows + r) * kRowBytes, &tma_a,
                              &full[s], k, m0 + r);
          for (int c = 0; c < ring.cols; c += kBox)
            sm90::tma_load_2d(
                st + ring.a_bytes + (b * ring.cols + c) * kRowBytes, &tma_b,
                &full[s], n0 + c, k);
        }
      }
    }
  } else {
    // ---- consumers: wgmma on the stages that have arrived ----
    sm90::setmaxnreg_inc<232>();
    const bool split_m = bm > kBox;
    if constexpr (N0 == N1) {
      const int row0 = split_m ? wg * (bm / 2) : 0;
      const int col0 = split_m ? 0 : wg * N0;
      consume<MT, N0>(ring, smem, full, empty, nk, row0, col0, Z, M, N, m0,
                      n0, bm, bn);
    } else if (wg == 0) {
      consume<MT, N0>(ring, smem, full, empty, nk, 0, 0, Z, M, N, m0, n0, bm,
                      bn);
    } else {
      consume<MT, N1>(ring, smem, full, empty, nk, 0, N0, Z, M, N, m0, n0,
                      bm, bn);
    }
  }
}

// Every (MT, N0, N1) instance the build has.  A tile of bm >= 128 runs
// MT = bm / 128 and N0 = N1 = bn (rounded up to 64); a tile of bm <= 64 runs
// MT = 1 with its 64-wide column boxes split between the two warpgroups,
// the odd one to warpgroup 0.  The accumulator, MT * W / 2 f32 a thread,
// stays within 128 registers.
#define TCM_WGMMA_INSTANCES(X)                                              \
  X(1, 64, 0) X(1, 64, 64) X(1, 128, 64) X(1, 128, 128) X(1, 192, 128)      \
  X(1, 192, 192) X(1, 256, 192) X(1, 256, 256) X(2, 64, 64)                 \
  X(2, 128, 128) X(4, 64, 64)

struct Split {
  int mt, n0, n1;
};

Split split_of(int bm, int bn) {
  const Ring ring(bm, kBox, bn);
  if (bm > kBox) return {bm / 128, ring.cols, ring.cols};
  const int n0 = (ring.cols / kBox + 1) / 2 * kBox;
  return {1, n0, ring.cols - n0};
}

// The index of the instance that runs a (bm, bn) tile, -1 if none does.
int instance_of(int bm, int bn) {
  if (bm <= 0 || bn <= 0 || (bm > kBox && bm != 128 && bm != 256 &&
                             bm != 512))
    return -1;
  const Split sp = split_of(bm, bn);
  int i = 0;
#define TCM_INDEX(MT, N0, N1)                                               \
  if (sp.mt == MT && sp.n0 == N0 && sp.n1 == N1) return i;                  \
  ++i;
  TCM_WGMMA_INSTANCES(TCM_INDEX)
#undef TCM_INDEX
  return -1;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; reach it through the
// runtime so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (outer, inner) bf16 matrix cut into 64 x 64 boxes, 128-byte
// swizzled; boxes past the edge read zeros.
bool make_map(CUtensorMap* map, const void* base, int inner, int outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {kBox, kBox};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT, int N0, int N1>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                         __nv_bfloat16* z, int M, int K, int N, int bm,
                         int bk, int bn, const Ring& ring,
                         cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgmma_matmul<MT, N0, N1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(M / bm, N / bn);
  wgmma_matmul<MT, N0, N1><<<grid, kWgmmaThreads, ring.smem(), stream>>>(
      ta, tb, z, M, N, bm, bk, bn, K / bk);
  return cudaGetLastError();
}

}  // namespace

// f32 (SIMT).  Returns a cudaError_t (0 = launched).
extern "C" int tcm_matmul_f32_launch(const void* a, const void* b, void* z,
                                     int M, int K, int N, int bm, int bk,
                                     int bn, void* stream) {
  if (bm <= 0 || bk <= 0 || bn <= 0 || M % bm || K % bk || N % bn)
    return cudaErrorInvalidValue;
  return launch_f32(static_cast<const float*>(a),
                    static_cast<const float*>(b), static_cast<float*>(z), M,
                    K, N, bm, bk, bn, static_cast<cudaStream_t>(stream));
}

// bf16 (TMA + wgmma).  The tile picks the instance (instance_of) and the
// ring its stage count.  a, b: 16-byte aligned, K and N multiples of 8 (TMA
// row strides); bk a multiple of 64, or the whole K below 64 (a stage holds
// 64-deep boxes).  Returns a cudaError_t (0 = launched).
extern "C" int tcm_matmul_bf16_launch(const void* a, const void* b, void* z,
                                      int M, int K, int N, int bm, int bk,
                                      int bn, void* stream) {
  if (bm <= 0 || bk <= 0 || bn <= 0 || M % bm || K % bk || N % bn ||
      K % 8 || N % 8 || (bk < kBox ? bk != K : bk % kBox != 0) ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return cudaErrorInvalidValue;
  const Ring ring(bm, bk, bn);
  if (ring.stages < 2) return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!make_map(&ta, a, K, M) || !make_map(&tb, b, N, K))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* zp = static_cast<__nv_bfloat16*>(z);
  const Split sp = split_of(bm, bn);
#define TCM_LAUNCH(MT, N0, N1)                                              \
  if (sp.mt == MT && sp.n0 == N0 && sp.n1 == N1)                            \
    return launch_wgmma<MT, N0, N1>(ta, tb, zp, M, K, N, bm, bk, bn, ring, s);
  if (instance_of(bm, bn) >= 0) {
    TCM_WGMMA_INSTANCES(TCM_LAUNCH)
  }
#undef TCM_LAUNCH
  return cudaErrorInvalidValue;
}

// The bf16 instance that runs a (bm, bn) tile, as an index below
// tcm_matmul_bf16_instances(); -1 for a tile no instance runs.
extern "C" int tcm_matmul_bf16_instance(int bm, int bn) {
  return instance_of(bm, bn);
}

extern "C" int tcm_matmul_bf16_instances() {
#define TCM_COUNT(MT, N0, N1) +1
  return 0 TCM_WGMMA_INSTANCES(TCM_COUNT);
#undef TCM_COUNT
}

extern "C" const char* tcm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
