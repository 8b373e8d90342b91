// Flash-attention forward for Hopper (sm_90a), bf16 or f32, Dh in {32,64,128}.
//
// Replaces: the Pallas TPU kernel _fa_kernel / flash_attention_pallas
// (src/repro/kernels/flash_attention.py), with its exact conventions:
// online softmax with f32 (m, l, acc), m starting at -1e30; scores scaled
// by 1/sqrt(Dh) in f32; causally masked scores set to -1e30 (top-left, both
// positions counted from 0, no q offset); p cast to v's dtype before P.V;
// out = acc / max(l, 1e-30); GQA by kv head h / (Hq / Hkv).  Keys past Sk
// (a ragged last tile) get p = 0 exactly.
//
// What bounds it here: prefill (Sq = Sk = 1024, Dh = 64) does ~64
// operations per byte of q, k, v and out per head, below the card's ~295
// bf16 operations per byte, so its bound is bytes; but only tensor cores
// come near either bound.  Decode (Sq = 1) reads the whole cache once per
// query row, ~1 operation per byte: bound by bytes, so it needs every
// thread's loads in flight.
//
// bf16, q tile bq >= 16 (fa_mma): tensor-core path.  One block of bq/16
// warps per (b * Hq + h, q tile); each warp owns 16 query rows.  Q, K and V
// arrive by cp.async (16-byte rows, zero-filled past Sq / Sk), K/V into a
// double-buffered ring so tile t+1 loads while tile t is multiplied.
// S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 -> f32 with operands
// from ldmatrix (V through its .trans form); S, P and O stay in registers,
// the S accumulator fragment is re-packed in place as P's A fragment, and
// each row's max and sum reduce across its quad of lanes by shuffles.
// Causal kv tiles wholly above a warp's last row are skipped (exact: every
// row's first tile holds key 0, so m is finite and a skipped tile adds
// p = 0, corr = 1), and the heaviest causal q tiles are scheduled first.
//
// bf16, q tile bq < 16 (fa_decode): one block of 256 threads per
// (b * Hq + h, query row) walks the kv tiles in order, so p rounds exactly
// as in the plain version, with every thread busy inside each tile: a
// group of Dh/8 lanes reads one key row with 16-byte loads and reduces the
// dot product by shuffles, a block-wide max and sum give m_new and the
// tile's sum, and for P V each thread owns 8 dims of one key group's
// partial sum, reduced across groups once at the end.
//
// f32 (fa_simt_f32): the first port's kernel, kept because mma on f32 is
// TF32 and the reference holds f32 at 2e-5.  128 threads per (b * Hq + h,
// q tile); 4x4 register micro-tiles of IEEE f32 FMAs for both products
// through shared memory, one thread per query row for the online softmax.
//
// q, k and v are read in their (B, S, H, Dh) layout through strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "sm90.cuh"
#include "tile.cuh"

namespace {

constexpr int kMaxSmem = 232448;
constexpr float kMasked = -1e30f;

// ---- bf16 tensor-core path ----------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

// d[16 x 8] += a[16 x 16] (row) * b[16 x 8] (col), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// Shared-memory rows are DH + 8 bf16 long: the 16-byte pad puts the 8 rows
// one ldmatrix reads on 8 different groups of banks.
template <int DH>
constexpr int kLd = DH + 8;

template <int DH>
size_t mma_smem_bytes(int bq, int bk) {
  return 2 * (size_t)kLd<DH> * (bq + 4 * (size_t)bk);
}

// rows x DH tile at src (row stride ld elements) into dst, zero past `valid`.
template <int DH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int rows, int valid) {
  constexpr int kChunks = DH / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * kLd<DH> + c, ok ? src + r * ld + c : src, ok);
  }
}

template <int DH, int BK>
__global__ void __launch_bounds__(256) fa_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int Hq, int Hkv, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int bq, float scale) {
  constexpr int LD = kLd<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + bq * LD;  // [2][BK][LD]
  __nv_bfloat16* vs = ks + 2 * BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;  // heaviest tiles first
  const int rows = min(bq, Sq - q0);
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int kv_end = causal ? min(Sk, q0 + rows) : Sk;
  const int ntiles = (kv_end + BK - 1) / BK;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane / 4, t4 = lane % 4;
  const int wrow = warp * 16;                  // the warp's first row
  const int qrow0 = q0 + wrow + g;             // rows of this lane
  const int warp_last = min(q0 + wrow + 15, Sq - 1);

  load_rows<DH>(qs, q + b * qsb + h * qsh + (long long)q0 * qss, qss, bq,
                rows);
  load_rows<DH>(ks, kb, kss, BK, min(BK, Sk));
  load_rows<DH>(vs, vb, vss, BK, min(BK, Sk));
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float acc[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {kMasked, kMasked}, l_r[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < ntiles) {
      const int nk0 = k0 + BK, buf = (t + 1) & 1;
      load_rows<DH>(ks + buf * BK * LD, kb + (long long)nk0 * kss, kss, BK,
                    min(BK, Sk - nk0));
      load_rows<DH>(vs + buf * BK * LD, vb + (long long)nk0 * vss, vss, BK,
                    min(BK, Sk - nk0));
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just requested
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        ldmatrix_x4(qf[kd], qs + (wrow + (lane % 16)) * LD + kd * 16 +
                                (lane / 16) * 8);
    }
    if (!(causal && k0 > warp_last) && wrow < rows) {
      const __nv_bfloat16* kt = ks + (t & 1) * BK * LD;
      const __nv_bfloat16* vt = vs + (t & 1) * BK * LD;
      // S = Q K^T: 16 x BK per warp
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
#pragma unroll
        for (int nj = 0; nj < BK / 16; ++nj) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, kt + (nj * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                               kd * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * nj], qf[kd], bfr[0], bfr[1]);
          mma_bf16(s[2 * nj + 1], qf[kd], bfr[2], bfr[3]);
        }
      }
      // online softmax on the two rows this lane holds
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qrow = qrow0 + (e >> 1) * 8;
          float x = s[j][e] * scale;
          if (key >= Sk)
            x = -CUDART_INF_F;  // past the cache: p = 0, no say in the max
          else if (causal && key > qrow)
            x = kMasked;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
        corr[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_r[e >> 1]);
          sum[e >> 1] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // O += P V, P re-packed from the S fragment as bf16
#pragma unroll
      for (int kj = 0; kj < BK / 16; ++kj) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kj][0], s[2 * kj][1]),
            pack_bf16(s[2 * kj][2], s[2 * kj][3]),
            pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
            pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
        for (int dj = 0; dj < DH / 16; ++dj) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, vt + (kj * 16 + (lane % 8) +
                                       ((lane / 8) % 2) * 8) * LD +
                                     dj * 16 + (lane / 16) * 8);
          mma_bf16(acc[2 * dj], pa, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dj + 1], pa, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffer is free for tile t + 2
  }

  __nv_bfloat16* ob = o + ((long long)b * Sq * Hq + h) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = qrow0 + 8 * r;
    if (qrow >= Sq) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)qrow * Hq * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

// ---- bf16 decode path ---------------------------------------------------

constexpr int kDecodeThreads = 256;

__device__ __forceinline__ void bf16x8_to_f32(uint4 raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Block-wide reduction of one value per thread (op: max or sum), result
// returned to every thread.  `red` holds one float per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(0xffffffff, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kDecodeThreads / 32; ++w)
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red is free again
  return x;
}

template <int DH>
size_t decode_smem_bytes(int bk) {
  return sizeof(float) * ((size_t)bk + kDecodeThreads / 32 +
                          (size_t)(kDecodeThreads / (DH / 8)) * DH);
}

template <int DH>
__global__ void __launch_bounds__(kDecodeThreads) fa_decode(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int Hq, int Hkv, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int bk, float scale) {
  constexpr int TPR = DH / 8;                    // lanes per key row
  constexpr int RPP = kDecodeThreads / TPR;      // key rows per pass
  extern __shared__ __align__(16) float dsm[];
  float* sc = dsm;                 // [bk] scores, then p rounded to bf16
  float* red = sc + bk;            // [warps]
  float* part = red + kDecodeThreads / 32;  // [RPP][DH] partial P V

  const int row = blockIdx.x, bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int sub = threadIdx.x % TPR, grp = threadIdx.x / TPR;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh + sub * 8;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh + sub * 8;

  float qv[8], acc[8];
  bf16x8_to_f32(*reinterpret_cast<const uint4*>(
                    q + b * qsb + (long long)row * qss + h * qsh + sub * 8),
                qv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    qv[i] *= scale;
    acc[i] = 0.f;
  }
  float m = kMasked, l = 0.f;
  const int kv_end = causal ? min(Sk, row + 1) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += bk) {
    const int cols = min(bk, Sk - k0);
    // scores: four key rows of loads in flight per lane group.  Every lane
    // runs every pass (the shuffles need the whole warp); rows past the
    // tile are masked.
    for (int p0 = 0; p0 < cols; p0 += 4 * RPP) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = p0 + grp + u * RPP;
        raw[u] = j < cols ? *reinterpret_cast<const uint4*>(
                                kb + (long long)(k0 + j) * kss)
                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kv[8], dot = 0.f;
        bf16x8_to_f32(raw[u], kv);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qv[i], kv[i], dot);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffff, dot, off);
        const int j = p0 + grp + u * RPP;
        if (sub == 0 && j < cols)
          sc[j] = (causal && k0 + j > row) ? kMasked : dot;
      }
    }
    __syncthreads();
    float mx = kMasked;
    for (int j = threadIdx.x; j < cols; j += kDecodeThreads)
      mx = fmaxf(mx, sc[j]);
    const float m_new = fmaxf(m, block_reduce<true>(mx, red));
    float sum = 0.f;
    for (int j = threadIdx.x; j < cols; j += kDecodeThreads) {
      const float p = expf(sc[j] - m_new);
      sum += p;
      sc[j] = __bfloat162float(__float2bfloat16(p));
    }
    const float corr = expf(m - m_new);
    l = l * corr + block_reduce<false>(sum, red);  // syncs: sc holds p
    m = m_new;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] *= corr;
    for (int p0 = 0; p0 < cols; p0 += 4 * RPP) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = p0 + grp + u * RPP;
        raw[u] = j < cols ? *reinterpret_cast<const uint4*>(
                                vb + (long long)(k0 + j) * vss)
                          : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = p0 + grp + u * RPP;
        const float p = j < cols ? sc[j] : 0.f;
        float vv[8];
        bf16x8_to_f32(raw[u], vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
      }
    }
    __syncthreads();  // sc is rewritten by the next tile
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[grp * DH + sub * 8 + i] = acc[i];
  __syncthreads();
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < DH; d += kDecodeThreads) {
    float x = 0.f;
    for (int gi = 0; gi < RPP; ++gi) x += part[gi * DH + d];
    o[(((long long)b * Sq + row) * Hq + h) * DH + d] = __float2bfloat16(x * inv);
  }
}

// ---- f32: SIMT ----------------------------------------------------------

constexpr int kSimtThreads = 128;

size_t simt_smem_bytes(int bq, int bk, int dh) {
  const int bq4 = tcm::round4(bq), bk4 = tcm::round4(bk);
  return sizeof(float) * ((size_t)dh * bq4 + (size_t)bk4 * bq4 +
                          (size_t)bq4 * dh + 3 * (size_t)bq4 +
                          2 * (size_t)bk4 * dh);
}

template <int DH>
__global__ void __launch_bounds__(kSimtThreads) fa_simt_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
    int Hq, int Hkv, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int bq, int bk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bq4 = tcm::round4(bq), bk4 = tcm::round4(bk);
  float* qT = reinterpret_cast<float*>(smem);  // [DH][bq4], scaled q
  float* sT = qT + DH * bq4;                   // [bk4][bq4], scores then p
  float* acc = sT + bk4 * bq4;                 // [bq4][DH]
  float* m_row = acc + bq4 * DH;               // [bq4]
  float* l_row = m_row + bq4;                  // [bq4]
  float* corr = l_row + bq4;                   // [bq4]
  float* ks = corr + bq4;                      // [bk4][DH]
  float* vs = ks + bk4 * DH;                   // [bk4][DH]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * bq;
  const int rows = min(bq, Sq - q0);
  const float* qb = q + b * qsb + h * qsh + (long long)q0 * qss;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  for (int i = threadIdx.x; i < bq4 * DH; i += blockDim.x) {
    const int r = i / DH, d = i - r * DH;
    qT[d * bq4 + r] = r < rows ? qb[r * qss + d] * scale : 0.f;
    acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < bq4; i += blockDim.x) {
    m_row[i] = kMasked;
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
      float mx = kMasked;
      for (int j = 0; j < cols; ++j) {
        float s = sT[j * bq4 + i];
        if (causal && k0 + j > q_pos) s = kMasked;
        sT[j * bq4 + i] = s;
        mx = fmaxf(mx, s);
      }
      const float m_prev = m_row[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < cols; ++j) {
        const float p = expf(sT[j * bq4 + i] - m_new);
        sum += p;
        sT[j * bq4 + i] = p;
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
  float* ob = o + (((long long)b * Sq + q0) * Hq + h) * DH;
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH, d = i - r * DH;
    ob[(long long)r * Hq * DH + d] = acc[r * DH + d] / fmaxf(l_row[r], 1e-30f);
  }
}

// ---- launches -----------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Sk, Hq, Hkv;
  const long long *qs, *ks, *vs;
  int causal, bq, bk;
  float scale;
};

template <typename Kernel>
cudaError_t set_smem_attr(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = e == cudaSuccess;
  return e;
}

template <int DH, int BK>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  if (a.bq % 16 || a.bq > 128) return cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes<DH>(a.bq, BK);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr = false;
  const cudaError_t e = set_smem_attr(fa_mma<DH, BK>, attr);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.B * a.Hq);
  fa_mma<DH, BK><<<grid, a.bq * 2, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.Sq, a.Sk, a.Hq, a.Hkv, a.qs[0],
      a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2],
      a.causal, a.bq, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_decode(const Args& a, cudaStream_t s) {
  const size_t smem = decode_smem_bytes<DH>(a.bk);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr = false;
  const cudaError_t e = set_smem_attr(fa_decode<DH>, attr);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.Sq, a.B * a.Hq);
  fa_decode<DH><<<grid, kDecodeThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.o), a.Sq, a.Sk, a.Hq, a.Hkv, a.qs[0],
      a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2], a.vs[0], a.vs[1], a.vs[2],
      a.causal, a.bk, a.scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const Args& a, cudaStream_t s) {
  if (a.bq < 16) return launch_decode<DH>(a, s);
  if (a.bk == 64) return launch_mma<DH, 64>(a, s);
  if (a.bk == 128) return launch_mma<DH, 128>(a, s);
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  const size_t smem = simt_smem_bytes(a.bq, a.bk, DH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static bool attr = false;
  const cudaError_t e = set_smem_attr(fa_simt_f32<DH>, attr);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + a.bq - 1) / a.bq, a.B * a.Hq);
  fa_simt_f32<DH><<<grid, kSimtThreads, smem, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq, a.Sk,
      a.Hq, a.Hkv, a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1], a.ks[2],
      a.vs[0], a.vs[1], a.vs[2], a.causal, a.bq, a.bk, a.scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, Hq, Dh), k / v: (B, Sk, Hkv, Dh), each with unit stride over
// Dh; *_strides give (batch, seq, head) strides in elements.  o is a
// contiguous (B, Sq, Hq, Dh) output.  dtype: 0 = float32, 1 = bfloat16
// (16-byte aligned rows: pointers and strides multiples of 8 elements).
// Returns a cudaError_t (0 = launched).
extern "C" int tcm_flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int Hq, int Hkv, int Dh, const long long* q_strides,
    const long long* k_strides, const long long* v_strides, int causal,
    int bq, int bk, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv || bq <= 0 ||
      bk <= 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, Sq, Sk, Hq, Hkv, q_strides, k_strides,
               v_strides, causal, bq, bk, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (Dh == 32) return launch_f32<32>(a, s);
    if (Dh == 64) return launch_f32<64>(a, s);
    if (Dh == 128) return launch_f32<128>(a, s);
  }
  if (dtype == 1) {
    if (Dh == 32) return launch_bf16<32>(a, s);
    if (Dh == 64) return launch_bf16<64>(a, s);
    if (Dh == 128) return launch_bf16<128>(a, s);
  }
  return cudaErrorInvalidValue;
}
