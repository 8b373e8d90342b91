// Flash-attention forward for Hopper (sm_90a), f32 or bf16, Dh in {32,64,128}.
//
// Replaces: the Pallas TPU kernel _fa_kernel / flash_attention_pallas
// (src/repro/kernels/flash_attention.py), with its exact conventions:
// online softmax with f32 (m, l, acc), m starting at -1e30; q scaled by
// 1/sqrt(Dh) in f32; causally masked scores set to -1e30 (top-left, both
// positions counted from 0, no q offset); p cast to v's dtype before P.V;
// out = acc / max(l, 1e-30); GQA by kv head h / (Hq / Hkv).
//
// What bounds it here: prefill attention (Sq = Sk = 1024, Dh = 64) does
// ~64 operations per byte of q, k, v and out per head, below the card's
// ~295 bf16 operations per byte, but well above what SIMT FMAs sustain,
// so this version is bound by its f32 FMA rate; decode (Sq = 1) reads the
// whole cache once per query and is bound by bytes.
//
// Design: one block of 128 threads per (b * Hq + h, q tile of bq rows).
// q, k and v are read in their (B, S, H, Dh) layout through strides, so no
// transposes are made.  The scaled q tile stays in shared memory for the
// block's life; the block then walks kv tiles of bk rows: S^T = K Q^T into
// shared memory (4x4 register micro-tiles), one thread per query row runs
// the online-softmax update over its column of S^T and overwrites it with
// p, then acc = acc * corr + P V.  Ragged Sq / Sk edges are masked in the
// kernel (rows past Sq are never stored; kv rows past Sk are zero and get
// p = 0), which is what Sq = 1 decode needs.  Causal kv tiles wholly above
// the q tile's last row are skipped: exact, since every row's first kv
// tile holds k = 0, so m is finite and a skipped tile adds p = 0, corr = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;

template <typename T>
size_t smem_bytes(int bq, int bk, int dh) {
  const int bq4 = tcm::round4(bq), bk4 = tcm::round4(bk);
  return sizeof(float) * ((size_t)dh * bq4 + (size_t)bk4 * bq4 +
                          (size_t)bq4 * dh + 3 * (size_t)bq4) +
         sizeof(T) * 2 * (size_t)bk4 * dh;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int Hq, int Hkv, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, int bq, int bk,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bq4 = tcm::round4(bq), bk4 = tcm::round4(bk);
  float* qT = reinterpret_cast<float*>(smem);  // [DH][bq4], scaled q
  float* sT = qT + DH * bq4;                   // [bk4][bq4], scores then p
  float* acc = sT + bk4 * bq4;                 // [bq4][DH]
  float* m_row = acc + bq4 * DH;               // [bq4]
  float* l_row = m_row + bq4;                  // [bq4]
  float* corr = l_row + bq4;                   // [bq4]
  T* ks = reinterpret_cast<T*>(corr + bq4);    // [bk4][DH]
  T* vs = ks + bk4 * DH;                       // [bk4][DH]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Sq - q0);
  const T* qb = q + b * qsb + h * qsh + (long long)q0 * qss;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int i = threadIdx.x; i < bq4 * DH; i += blockDim.x) {
    const int r = i / DH, d = i - r * DH;
    qT[d * bq4 + r] = r < rows ? tcm::to_f32(qb[r * qss + d]) * scale : 0.f;
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < bq4; i += blockDim.x) {
    m_row[i] = -1e30f;
    l_row[i] = 0.f;
  }

  // causal: query row q0 + rows - 1 sees keys 0 .. q0 + rows - 1
  const int kv_end = causal ? min(Sk, q0 + rows) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += bk) {
    const int cols = min(bk, Sk - k0);
    __syncthreads();  // previous tile's reads of ks / vs / sT are done
    tcm::load_tile(ks, kb + (long long)k0 * kss, kss, cols, DH, bk4, DH);
    tcm::load_tile(vs, vb + (long long)k0 * vss, vss, cols, DH, bk4, DH);
    __syncthreads();
    // S^T[j][i] = sum_d K[j][d] * (scale * Q)[i][d]
    tcm::mm_acc<false>(ks, DH, qT, bq4, sT, bq4, bk4, bq4, DH, nullptr,
                       false);
    __syncthreads();
    for (int i = threadIdx.x; i < bq4; i += blockDim.x) {
      const int q_pos = q0 + i;
      float mx = -1e30f;
      for (int j = 0; j < cols; ++j) {
        float s = sT[j * bq4 + i];
        if (causal && k0 + j > q_pos) s = -1e30f;
        sT[j * bq4 + i] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = m_row[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < cols; ++j) {
        const float p = expf(sT[j * bq4 + i] - m_new);
        sum += p;
        sT[j * bq4 + i] = tcm::to_f32(tcm::from_f32<T>(p));
      }
      for (int j = cols; j < bk4; ++j) sT[j * bq4 + i] = 0.f;
      const float c = expf(m_prev - m_new);
      l_row[i] = l_row[i] * c + sum;
      m_row[i] = m_new;
      corr[i] = c;
    }
    __syncthreads();
    // acc[i][d] = acc[i][d] * corr[i] + sum_j p[i][j] * V[j][d]
    tcm::mm_acc<true>(sT, bq4, vs, DH, acc, DH, bq4, DH, bk4, corr, true);
  }
  __syncthreads();
  T* ob = o + (((long long)b * Sq + q0) * Hq + h) * DH;
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH, d = i - r * DH;
    ob[(long long)r * Hq * DH + d] =
        tcm::from_f32<T>(acc[r * DH + d] / fmaxf(l_row[r], 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv,
                   const long long* qs, const long long* ks,
                   const long long* vs, int causal, int bq, int bk,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(bq, bk, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid((Sq + bq - 1) / bq, B * Hq);
  fa_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal, bq, bk,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int Dh, const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Sk, int Hq, int Hkv,
                        const long long* qs, const long long* ks,
                        const long long* vs, int causal, int bq, int bk,
                        float scale, cudaStream_t s) {
  switch (Dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, Hq, Hkv, qs, ks, vs, causal,
                           bq, bk, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, qs, ks, vs, causal,
                           bq, bk, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, qs, ks, vs,
                            causal, bq, bk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, Hq, Dh), k / v: (B, Sk, Hkv, Dh), each with unit stride over
// Dh; *_strides give (batch, seq, head) strides in elements.  o is a
// contiguous (B, Sq, Hq, Dh) output.  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t (0 = launched).
extern "C" int tcm_flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int Dh, const long long* q_strides,
    const long long* k_strides, const long long* v_strides, int causal,
    int bq, int bk, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv || bq <= 0 ||
      bk <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(Dh, q, k, v, o, B, Sq, Sk, Hq, Hkv, q_strides,
                              k_strides, v_strides, causal, bq, bk, scale, s);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, Sq, Sk, Hq, Hkv,
                                      q_strides, k_strides, v_strides, causal,
                                      bq, bk, scale, s);
  return cudaErrorInvalidValue;
}
