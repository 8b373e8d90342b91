// The mapper's packed criteria evaluation (its innermost search step) in
// f64 on the card: out[i, j] = sum over the terms of criterion j of
// coeff * prod(cols[i, c] ** e), one block per tile of R candidate rows.
//
// Replaces: no Pallas kernel.  The reference evaluates the same step with a
// jax.jit of its packed form when TCM_JIT is set (CriteriaKernel._call_jit,
// src/repro/core/symbolic.py); the port's route (repro_torch/kernels/
// criteria.py, behind core/symbolic.py's set_jit) launches this kernel
// instead, and numpy stays the search's reference.
//
// Bit for bit the numpy path (CriteriaKernel.__call__), so pruning with the
// route on decides exactly as with it off.  The order of operations is
// fixed per scalar and every operation is an explicitly rounded intrinsic
// (__dmul_rn, __dadd_rn, __ddiv_rn), which nvcc never contracts into an FMA:
//   - a factor col**e reads the column for e == 1, is x*x for e == 2
//     (numpy's square), and repeated products for e >= 3: equal to numpy's
//     pow wherever the exact power is representable in f64 (every step is
//     then exact); a negative e is 1 / x**(-e), numpy's reciprocal for -1;
//   - a term is coeff * f0, then * f1, * f2 ... left to right; a term with
//     no factor reads the constant factor 1.0 (coeff * 1.0, as numpy does);
//   - a criterion starts from its first term and adds the others in their
//     order; an empty criterion is 0.0.
// Tensor cores (DMMA) would reorder the sums, so the card's resources that
// apply are its shared memory, its bulk copies and its SMs.
//
// What bounds it: by bytes (the columns in, the criteria out) the card
// could do 20000 rows of the heaviest kernel the search meets in about a
// microsecond, and the search's calls (a median of ~90 rows) in well under
// one; by f64 operations less still.  So latency bounds it, and the design
// cuts the chain of dependent loads behind each output.  The description
// (criteria.py's ``pack``: a header, then numpy's packing: per factor its
// column and exponent, per term row its coefficient and factor ids, per
// criterion its term rows; each section 16-byte aligned, a few KB) and the
// block's rows of columns arrive in shared memory by 1-D bulk copies on
// one mbarrier, issued by one thread; then three phases, each thread over
// (item, row):
//   1. F[f, r], every factor once per row, as numpy computes each once;
//   2. T[t, r], every term once per row, from F;
//   3. each criterion's terms summed in order from T, then written out
//      coalesced.
// No thread reads the description from global memory inside a loop.  The
// host picks R, a power of two (criteria.py's ``tile_plan``), so that the
// tile fits in shared memory and a large call spreads over the 132 SMs (a
// call of up to 4 rows is one block), and a thread for each item of each
// row, up to 256.  On an H100 (chip_smoke.py phase 7b) it takes ~4.5-5.4
// us up to 1024 rows, about a launch's latency, and ~9 us at 15000-20000
// rows, where every block stages the description again and waits for its
// tile before it computes (a persistent block with a ring of tiles would
// overlap the two).
//
// ``tcm_criteria_eval`` is the search's call: one pinned host-to-device
// copy of the description and the columns, the launch, one device-to-host
// copy of the criteria into pinned memory and one stream synchronisation.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

// The description's header: int32 words at its start, in the order of
// criteria.py's HEADER (total bytes, counts, then each section's offset).
// The terms keep numpy's packing: rows sorted by factor count, factor slot
// q reaching the rows from its cut on.
enum Header {
  kBytes, kFactors, kTerms, kCrits, kCols, kSlots,
  kFac, kSlot, kCoeff, kFid0, kSlotFac, kCritPtr, kCritTerm
};

constexpr int kMaxThreads = 256;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory on sm_90

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// A tile's staged rows: R * n_syms doubles, 8 bytes in when the tile starts
// 8 bytes past a 16-byte boundary of global memory (so that the bulk copy's
// 16-byte span lands 16-byte aligned in shared memory too).
__host__ __device__ constexpr size_t stage_bytes(int R, int n_syms) {
  return round16(8 * (size_t)R * n_syms + 8);
}

// The mbarrier (16 bytes), the description, the staged rows, F, T and the
// criteria (8 bytes a row and item each), and each term row's factor count.
__host__ __device__ constexpr size_t smem_bytes(int desc_bytes, int R,
                                                int n_syms, int nf, int nt,
                                                int n_crits) {
  return 16 + (size_t)desc_bytes + stage_bytes(R, n_syms) +
         8 * (size_t)R * (nf + 1 + nt + n_crits) + 4 * (size_t)nt;
}

__device__ __forceinline__ double power(double x, int e) {
  if (e == 1) return x;
  const int k = e < 0 ? -e : e;
  double p = x;
  for (int q = 1; q < k; ++q) p = __dmul_rn(p, x);
  return e < 0 ? __ddiv_rn(1.0, p) : p;
}

__global__ void __launch_bounds__(kMaxThreads)
    criteria_kernel(const unsigned char* __restrict__ desc, int desc_bytes,
                    int nf, int nt, int n_crits,
                    const double* __restrict__ cols, long long n, int n_syms,
                    int lg, double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 1 << lg;  // rows a block: F and T hold item f's row r at
                          // (f << lg) + r
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* sdesc = smem + 16;
  unsigned char* stage = sdesc + desc_bytes;
  double* F = reinterpret_cast<double*>(stage + stage_bytes(R, n_syms));
  double* T = F + ((size_t)(nf + 1) << lg);
  double* O = T + ((size_t)nt << lg);
  int* count = reinterpret_cast<int*>(O + ((size_t)n_crits << lg));

  const int tid = threadIdx.x, step = blockDim.x;
  const long long i0 = (long long)blockIdx.x << lg;
  const int rows = (int)min((long long)R, n - i0);
  const long long n_vals = (long long)rows * n_syms;
  const double* g = cols + i0 * n_syms;
  // the tile's bytes [a, b) in global memory; the bulk copy takes their
  // 16-byte aligned span [a16, b16), the first and last value outside it
  // (at most one each) are loaded directly
  const uintptr_t a = reinterpret_cast<uintptr_t>(g), b = a + 8 * n_vals;
  const uintptr_t a16 = (a + 15) & ~uintptr_t(15), b16 = b & ~uintptr_t(15);
  double* xs = reinterpret_cast<double*>(stage + (a & 15));

  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bulk = b16 > a16 ? static_cast<uint32_t>(b16 - a16) : 0;
    sm90::mbar_expect_tx(bar, desc_bytes + bulk);
    sm90::bulk_load_1d(sdesc, desc, desc_bytes, bar);
    if (bulk)
      sm90::bulk_load_1d(reinterpret_cast<unsigned char*>(xs) + (a16 - a),
                         reinterpret_cast<const void*>(a16), bulk, bar);
  } else if (tid <= 2 && n_vals > 0) {
    const long long k = tid == 1 ? 0 : n_vals - 1;
    const uintptr_t at = a + 8 * k;
    if ((tid == 1 || k > 0) && (at < a16 || at + 8 > b16)) xs[k] = g[k];
  }
  // the copies are issued and the direct loads done before any thread
  // spins on the barrier (a spin beside the issuing lane of its own warp
  // held that lane back until the wait gave up)
  __syncthreads();
  sm90::mbar_wait(bar, 0);

  const int* h = reinterpret_cast<const int*>(sdesc);
  const int* fac = reinterpret_cast<const int*>(sdesc + h[kFac]);
  const int2* slot = reinterpret_cast<const int2*>(sdesc + h[kSlot]);
  const double* coeff = reinterpret_cast<const double*>(sdesc + h[kCoeff]);
  const int* fid0 = reinterpret_cast<const int*>(sdesc + h[kFid0]);
  const int* slot_fac = reinterpret_cast<const int*>(sdesc + h[kSlotFac]);
  const int* crit_ptr = reinterpret_cast<const int*>(sdesc + h[kCritPtr]);
  const int* crit_term = reinterpret_cast<const int*>(sdesc + h[kCritTerm]);
  const int n_slots = h[kSlots];

  // 1. every factor once per row (the last, nf, is the constant 1.0); and
  // each term row's factor count, 1 + the slots (cut, offset) whose cut is
  // at most its row, by the block's last threads (idle here in a small
  // tile)
  for (int k = tid; k < (nf + 1) << lg; k += step) {
    const int f = k >> lg, r = k & (R - 1);
    if (r < rows)
      F[k] = f == nf ? 1.0
                     : power(xs[r * n_syms + fac[2 * f]], fac[2 * f + 1]);
  }
  for (int t = step - 1 - tid; t < nt; t += step) {
    int c = 1;
    for (int q = 0; q < n_slots; ++q) c += slot[q].x <= t;
    count[t] = c;
  }
  __syncthreads();
  // 2. every term once per row: its coefficient times its factors in order
  // (the factors' loads do not wait on the running product)
  for (int k = tid; k < nt << lg; k += step) {
    const int t = k >> lg, r = k & (R - 1);
    if (r >= rows) continue;
    const int c = count[t] - 1;
    double v = __dmul_rn(coeff[t], F[(fid0[t] << lg) + r]);
#pragma unroll 4
    for (int q = 0; q < c; ++q)
      v = __dmul_rn(v, F[(slot_fac[slot[q].y + t - slot[q].x] << lg) + r]);
    T[k] = v;
  }
  __syncthreads();
  // 3. each criterion's terms in order, into O in the output's layout ...
  for (int k = tid; k < n_crits << lg; k += step) {
    const int j = k >> lg, r = k & (R - 1);
    if (r >= rows) continue;
    const int t0 = crit_ptr[j], t1 = crit_ptr[j + 1];
    double acc = t0 < t1 ? T[(crit_term[t0] << lg) + r] : 0.0;
#pragma unroll 4
    for (int t = t0 + 1; t < t1; ++t)
      acc = __dadd_rn(acc, T[(crit_term[t] << lg) + r]);
    O[r * n_crits + j] = acc;
  }
  __syncthreads();
  // ... then written coalesced: the tile's rows of out are one contiguous
  // run
  double* o = out + i0 * n_crits;
  for (int k = tid; k < rows * n_crits; k += step) o[k] = O[k];
}

cudaError_t launch(const void* desc, int desc_bytes, int nf, int nt,
                   int n_crits, const double* cols, long long n, int n_syms,
                   int lg, int threads, double* out, cudaStream_t stream) {
  if (n <= 0 || n_crits <= 0 || lg < 0 || lg > 20 || n_syms < 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      desc_bytes <= 0 || desc_bytes % 16 ||
      reinterpret_cast<uintptr_t>(desc) % 16 ||
      reinterpret_cast<uintptr_t>(cols) % 8)
    return cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes(desc_bytes, 1 << lg, n_syms, nf, nt, n_crits);
  const long long blocks = (n + (1 << lg) - 1) >> lg;
  if (smem > kMaxSmem || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        criteria_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  criteria_kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const unsigned char*>(desc), desc_bytes, nf, nt, n_crits,
      cols, n, n_syms, lg, out);
  return cudaGetLastError();
}

}  // namespace

// cols (n, n_syms) f64 row-major on the card -> out (n, n_crits) f64
// row-major, on `stream`, with the description `desc` (16-byte aligned,
// `desc_bytes` a multiple of 16; nf factors, nt terms) on the card, 2^lg
// rows and `threads`
// threads a block.  Returns the launch's CUDA error (0 when it was
// accepted).
extern "C" int tcm_criteria_launch(const void* desc, int desc_bytes, int nf,
                                   int nt, int n_crits, const double* cols,
                                   long long n, int n_syms, int lg,
                                   int threads, double* out, void* stream) {
  return static_cast<int>(launch(desc, desc_bytes, nf, nt, n_crits, cols, n,
                                 n_syms, lg, threads, out,
                                 static_cast<cudaStream_t>(stream)));
}

// One call of the search on card `device`: `host_in` (pinned) holds the
// description and, `desc_bytes` after it, the columns (`in_bytes` in all);
// they go to `dev_in` in one copy, the kernel writes `dev_out`, the
// criteria come back to `host_out` (pinned) in one copy, and the stream is
// synchronised.  The thread's current device is restored.  Returns the
// first CUDA error (0 when the criteria are in `host_out`).
extern "C" int tcm_criteria_eval(int device, const void* host_in,
                                 void* dev_in, long long in_bytes,
                                 int desc_bytes, int nf, int nt, int n_crits,
                                 long long n, int n_syms, int lg,
                                 int threads, void* dev_out, void* host_out,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(dev_in, host_in, static_cast<size_t>(in_bytes),
                        cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = launch(dev_in, desc_bytes, nf, nt, n_crits,
               reinterpret_cast<const double*>(
                   static_cast<const unsigned char*>(dev_in) + desc_bytes),
               n, n_syms, lg, threads, static_cast<double*>(dev_out), s);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(host_out, dev_out, 8 * static_cast<size_t>(n) *
                        n_crits, cudaMemcpyDeviceToHost, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}
