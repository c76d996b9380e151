// pdist_rankeval: the planner's stage in one launch.  For every (query b,
// group g): dq = sqrt(gram_sq(q_b, piv_g)), then rank_math at dq - rg_b and
// dq + rg_b.  Writes dq (B, G) f32 and rank_lo, rank_hi (G, B) int32.
//
// Replaces the Pallas kernel repro/kernels/fused.py::pdist_rankeval_pallas
// (body _pdist_rankeval_kernel).  It calls the same gram.cuh and rank_math.cuh
// functions as the staged pdist -> sqrt -> rankeval chain, and the square root
// is the IEEE one, so both plans agree bit for bit.
//
// What bounds it on an H100: launch overhead.  At the plan's shape (64 queries
// x 192 groups, d = 8) it moves about 150 KB and does about 1.5 MFLOP, a
// microsecond of work, so the launch costs more than the arithmetic.  One
// thread per (b, g) pair.
//
// First, unoptimised version: operands read straight from global memory.
#include <cuda_runtime.h>

#include "gram.cuh"
#include "rank_math.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pdist_rankeval_kernel(const float* __restrict__ q, const float* __restrict__ piv,
                      const float* __restrict__ coef, const float* __restrict__ lo,
                      const float* __restrict__ hi, const float* __restrict__ n,
                      const float* __restrict__ rg, float* __restrict__ dq_out,
                      int* __restrict__ rank_lo, int* __restrict__ rank_hi,
                      int B, int G, int d, int n_coef, int n_rings) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (idx >= (long long)B * G) return;
    const int b = (int)(idx / G);
    const int g = (int)(idx - (long long)b * G);
    const float* qb = q + (long long)b * d;
    const float* pg = piv + (long long)g * d;
    const float d2 = gram_sq(sq_norm(qb, 1, d), sq_norm(pg, 1, d), qb, 1, pg, 1, d);
    const float dq = __fsqrt_rn(d2);
    dq_out[idx] = dq;
    const float* cg = coef + (long long)g * n_coef;
    const long long o = (long long)g * B + b;
    int rid;
    rank_math(__fsub_rn(dq, rg[b]), cg, n_coef, lo[g], hi[g], n[g], n_rings,
              rank_lo + o, &rid);
    rank_math(__fadd_rn(dq, rg[b]), cg, n_coef, lo[g], hi[g], n[g], n_rings,
              rank_hi + o, &rid);
}

}  // namespace

// q (B, d), piv (G, d), coef (G, C), lo/hi/n (G,), rg (B,) f32;
// dq (B, G) f32; rank_lo/rank_hi (G, B) int32.
extern "C" int pdist_rankeval(const void* q, const void* piv, const void* coef,
                              const void* lo, const void* hi, const void* n,
                              const void* rg, void* dq, void* rank_lo,
                              void* rank_hi, int B, int G, int d, int n_coef,
                              int n_rings, void* stream) {
    if (B <= 0 || G <= 0) return 0;
    const long long total = (long long)B * G;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    pdist_rankeval_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)piv, (const float*)coef,
        (const float*)lo, (const float*)hi, (const float*)n, (const float*)rg,
        (float*)dq, (int*)rank_lo, (int*)rank_hi, B, G, d, n_coef, n_rings);
    return (int)cudaGetLastError();
}
