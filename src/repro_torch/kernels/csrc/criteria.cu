// The mapper's packed criteria evaluation (its innermost search step) in
// f64 on the card: out[i, j] = sum over the terms of criterion j of
// coeff * prod(cols[i, c] ** e), one thread per (candidate row, criterion).
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
//
// What bounds it here: by bytes (the columns in, the criteria out) the
// card could do even fig8's 20000 rows in about a microsecond, and at the
// search's batch sizes (a median of 3-323 rows a call) far less.  This
// simple kernel instead runs ~18-22 us from 3 to 20000 rows on an H100
// (chip_smoke.py phase 7b), flat, so latency and not bytes: most likely
// the chain of dependent global loads each thread walks (criterion -> term
// -> factor -> column), with a small batch one block on one SM.  Staging the description in shared
// memory would cut that chain; around it, the route's copies and Python
// (~90-600 us a call) dominate anyway.  The description (per term its
// coefficient and factor ids, per criterion its term rows) is uploaded
// once per CriteriaKernel and read through the read-only cache; each
// thread recomputes each factor where it is used (numpy computes each once
// per row; the value is the same).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double factor(const double* row, int col, int e) {
  if (col < 0) return 1.0;  // the constant factor of a term with none
  const double x = row[col];
  if (e == 1) return x;
  const int k = e < 0 ? -e : e;
  double p = x;
  for (int q = 1; q < k; ++q) p = __dmul_rn(p, x);
  return e < 0 ? __ddiv_rn(1.0, p) : p;
}

__global__ void criteria_kernel(const double* __restrict__ cols, long long n,
                                int n_syms, const int* __restrict__ fac_col,
                                const int* __restrict__ fac_exp,
                                const double* __restrict__ term_coeff,
                                const int* __restrict__ term_ptr,
                                const int* __restrict__ term_fac,
                                const int* __restrict__ crit_ptr,
                                const int* __restrict__ crit_term,
                                int n_crits, double* __restrict__ out) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n * n_crits) return;
  const long long i = idx / n_crits;
  const int j = static_cast<int>(idx - i * n_crits);
  const double* row = cols + i * n_syms;
  const int t0 = __ldg(crit_ptr + j), t1 = __ldg(crit_ptr + j + 1);
  double acc = 0.0;
  for (int t = t0; t < t1; ++t) {
    const int r = __ldg(crit_term + t);
    double v = __ldg(term_coeff + r);
    for (int q = __ldg(term_ptr + r); q < __ldg(term_ptr + r + 1); ++q) {
      const int f = __ldg(term_fac + q);
      v = __dmul_rn(v, factor(row, __ldg(fac_col + f), __ldg(fac_exp + f)));
    }
    acc = t == t0 ? v : __dadd_rn(acc, v);
  }
  out[idx] = acc;
}

constexpr int kThreads = 256;

}  // namespace

// cols (n, n_syms) f64 row-major -> out (n, n_crits) f64 row-major, on
// `stream`.  Returns the launch's CUDA error (0 when it was accepted).
extern "C" int tcm_criteria_launch(const double* cols, long long n,
                                   int n_syms, const int* fac_col,
                                   const int* fac_exp,
                                   const double* term_coeff,
                                   const int* term_ptr, const int* term_fac,
                                   const int* crit_ptr, const int* crit_term,
                                   int n_crits, double* out, void* stream) {
  const long long total = n * n_crits;
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + kThreads - 1) / kThreads;
  criteria_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      cols, n, n_syms, fac_col, fac_exp, term_coeff, term_ptr, term_fac,
      crit_ptr, crit_term, n_crits, out);
  return static_cast<int>(cudaGetLastError());
}
