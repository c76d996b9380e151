// pdist_rankeval: the planner's stage in one launch.  For every (query b,
// group g): dq = sqrt(gram_sq(q_b, piv_g)), then rank_math at dq - rg_b and
// dq + rg_b.  Writes dq (B, G) f32 and rank_lo, rank_hi (G, B) int32.
//
// Replaces the Pallas kernel repro/kernels/fused.py::pdist_rankeval_pallas
// (:58; body _pdist_rankeval_kernel :29).  It calls the same gram.cuh and
// rank_math.cuh functions as the staged pdist -> sqrt -> rankeval chain, and
// the square root is the IEEE one, so both plans agree bit for bit.
//
// What bounds it on an H100: latency.  At the plan's shape (64 queries x 192
// groups, d = 8, C = 9) it moves about 150 KB and does about 2 MFLOP, a
// microsecond of work, so the launch and the chain of dependent steps a
// block runs (loads, norms, the Gram sum, the square root, the rank math,
// the stores) are the cost.  The design keeps that chain short and the same
// at any shape:
// - a block owns a tile of TB = 8 queries x TG = 8 groups, one pair a
//   thread, so the plan's shape gives 192 blocks, enough for all 132 SMs.
//   The tile is a launch parameter (the autotuner's bb = TB and bg = TG,
//   each 8, the static tile, or 16), one template instantiation each; every
//   pair is one thread's arithmetic, so no result depends on it;
// - the tile's query and pivot norms (gram.cuh's sq_norm), its groups'
//   constants (rank_group) and coefficients are staged once in shared
//   memory; C is a template parameter (1..16, the runtime loop for any
//   other C), with the coefficients in registers;
// - the lo and hi rank chains of a pair run interleaved (rank_math with V =
//   2);
// - dq is stored by threads that hold neighbouring groups, and the ranks go
//   through shared memory to threads that hold neighbouring queries, so
//   every store writes whole 32-byte runs of a row.
#include <climits>

#include <cuda_runtime.h>

#include "gram.cuh"
#include "rank_math.cuh"

namespace {

// TB queries x TG groups a block, one pair a thread
template <int C, int TB, int TG>
__global__ void __launch_bounds__(TB * TG)
pdist_rankeval_kernel(const float* __restrict__ q, const float* __restrict__ piv,
                      const float* __restrict__ coef, const float* __restrict__ lo,
                      const float* __restrict__ hi, const float* __restrict__ n,
                      const float* __restrict__ rg, float* __restrict__ dq_out,
                      int* __restrict__ rank_lo, int* __restrict__ rank_hi,
                      int B, int G, int d, int n_coef, int n_rings,
                      unsigned gtiles) {
    constexpr int THREADS = TB * TG;
    static_assert(TB + 2 * TG <= THREADS, "staging takes TB + 2 TG threads");
    extern __shared__ float c_s[];              // (TG, n_coef)
    __shared__ RankGroup grp_s[TG];
    __shared__ float qn_s[TB], rg_s[TB], pn_s[TG];
    __shared__ int lo_s[TG][TB + 1], hi_s[TG][TB + 1];
    const int tid = threadIdx.x;
    const unsigned bt = blockIdx.x / gtiles;
    const int b0 = (int)bt * TB;
    const int g0 = (int)(blockIdx.x - bt * gtiles) * TG;

    if (tid < TB) {
        const int b = b0 + tid;
        if (b < B) {
            qn_s[tid] = sq_norm(q + (long long)b * d, 1, d);
            rg_s[tid] = rg[b];
        }
    } else if (tid < TB + TG) {
        const int g = g0 + tid - TB;
        if (g < G) pn_s[tid - TB] = sq_norm(piv + (long long)g * d, 1, d);
    } else if (tid < TB + 2 * TG) {
        const int g = g0 + tid - TB - TG;
        if (g < G) grp_s[tid - TB - TG] = rank_group(lo[g], hi[g], n[g],
                                                     n_rings);
    }
    const int live_c = (G - g0 < TG ? G - g0 : TG) * n_coef;
    for (int e = tid; e < live_c; e += THREADS)
        c_s[e] = coef[(long long)g0 * n_coef + e];
    __syncthreads();

    // the pair: neighbouring threads on neighbouring groups
    const int bl = tid / TG, gl = tid % TG;
    const int b = b0 + bl, g = g0 + gl;
    if (b < B && g < G) {
        const float* qb = q + (long long)b * d;
        const float* pg = piv + (long long)g * d;
        const float dq = __fsqrt_rn(gram_sq(qn_s[bl], pn_s[gl], qb, 1, pg, 1,
                                            d));
        dq_out[(long long)b * G + g] = dq;
        float c[C > 0 ? C : 1];
#pragma unroll
        for (int k = 0; k < C; ++k) c[k] = c_s[gl * n_coef + k];
        const float x[2] = {__fsub_rn(dq, rg_s[bl]), __fadd_rn(dq, rg_s[bl])};
        int rk[2], rid[2];
        rank_math<C, 2>(x, C > 0 ? c : c_s + gl * n_coef, n_coef, grp_s[gl],
                        n_rings, rk, rid);
        lo_s[gl][bl] = rk[0];
        hi_s[gl][bl] = rk[1];
    }
    __syncthreads();

    // the ranks, (G, B): neighbouring threads on neighbouring queries
    const int gs = tid / TB, bs = tid % TB;
    if (b0 + bs < B && g0 + gs < G) {
        const long long o = (long long)(g0 + gs) * B + b0 + bs;
        rank_lo[o] = lo_s[gs][bs];
        rank_hi[o] = hi_s[gs][bs];
    }
}

template <int C, int TB, int TG>
int launch(const float* q, const float* piv, const float* coef,
           const float* lo, const float* hi, const float* n, const float* rg,
           float* dq, int* rank_lo, int* rank_hi, int B, int G, int d,
           int n_coef, int n_rings, cudaStream_t stream) {
    const long long btiles = ((long long)B + TB - 1) / TB;
    const long long gtiles = ((long long)G + TG - 1) / TG;
    if (btiles * gtiles > INT_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)TG * n_coef * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pdist_rankeval_kernel<C, TB, TG>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    pdist_rankeval_kernel<C, TB, TG>
        <<<(unsigned)(btiles * gtiles), TB * TG, smem, stream>>>(
            q, piv, coef, lo, hi, n, rg, dq, rank_lo, rank_hi, B, G, d,
            n_coef, n_rings, (unsigned)gtiles);
    return (int)cudaGetLastError();
}

// The tile of bb queries x bg groups, each 8 or 16.
template <int C>
int launch_tile(const float* q, const float* piv, const float* coef,
                const float* lo, const float* hi, const float* n,
                const float* rg, float* dq, int* rank_lo, int* rank_hi, int B,
                int G, int d, int n_coef, int n_rings, int bb, int bg,
                cudaStream_t stream) {
#define FUSED_TILE(tb, tg)                                                 \
    if (bb == tb && bg == tg)                                              \
        return launch<C, tb, tg>(q, piv, coef, lo, hi, n, rg, dq, rank_lo, \
                                 rank_hi, B, G, d, n_coef, n_rings, stream);
    FUSED_TILE(8, 8) FUSED_TILE(8, 16) FUSED_TILE(16, 8) FUSED_TILE(16, 16)
#undef FUSED_TILE
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, d), piv (G, d), coef (G, C), lo/hi/n (G,), rg (B,) f32;
// dq (B, G) f32; rank_lo/rank_hi (G, B) int32; the tile bb queries x bg
// groups.
extern "C" int pdist_rankeval(const void* q, const void* piv, const void* coef,
                              const void* lo, const void* hi, const void* n,
                              const void* rg, void* dq, void* rank_lo,
                              void* rank_hi, int B, int G, int d, int n_coef,
                              int n_rings, int bb, int bg, void* stream) {
    if (B <= 0 || G <= 0) return 0;
    if (n_coef <= 0) return (int)cudaErrorInvalidValue;
    const float *qf = (const float*)q, *pf = (const float*)piv;
    const float *cf = (const float*)coef, *lf = (const float*)lo;
    const float *hf = (const float*)hi, *nf = (const float*)n;
    const float* rf = (const float*)rg;
    float* df = (float*)dq;
    int *rl = (int*)rank_lo, *rh = (int*)rank_hi;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (n_coef) {
#define FUSED_CASE(c)                                                      \
    case c:                                                                \
        return launch_tile<c>(qf, pf, cf, lf, hf, nf, rf, df, rl, rh, B, G, \
                              d, n_coef, n_rings, bb, bg, s);
        FUSED_CASE(1) FUSED_CASE(2) FUSED_CASE(3) FUSED_CASE(4)
        FUSED_CASE(5) FUSED_CASE(6) FUSED_CASE(7) FUSED_CASE(8)
        FUSED_CASE(9) FUSED_CASE(10) FUSED_CASE(11) FUSED_CASE(12)
        FUSED_CASE(13) FUSED_CASE(14) FUSED_CASE(15) FUSED_CASE(16)
#undef FUSED_CASE
        default:
            return launch_tile<0>(qf, pf, cf, lf, hf, nf, rf, df, rl, rh, B,
                                  G, d, n_coef, n_rings, bb, bg, s);
    }
}
