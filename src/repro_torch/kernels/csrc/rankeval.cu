// rankeval: evaluate each (cluster, pivot) group's Chebyshev rank model on a
// (G, B) block of distances and derive ring ids, rank/rid (G, B) int32.
//
// Replaces the Pallas kernel repro/kernels/rankeval.py::rankeval_pallas
// (body _rankeval_kernel using rank_math).  The arithmetic lives in
// rank_math.cuh, shared with pdist_rankeval.cu.
//
// What bounds it on an H100: at the snapshot's certification shape (192
// groups x 72k sorted distances) it reads 55 MB and writes 110 MB, about
// 0.05 ms at 3.35 TB/s; its ~40 f32 operations per value are far below the
// card's rate.  At the staged plan's shape (192 x 2B) it is a single small
// launch and bound by launch overhead.  One thread per value, neighbouring
// threads on neighbouring values of one group, so loads and stores coalesce;
// the group's coefficients sit in shared memory.
//
// First, unoptimised version.
#include <cuda_runtime.h>

#include "rank_math.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
rankeval_kernel(const float* __restrict__ x, const float* __restrict__ coef,
                const float* __restrict__ lo, const float* __restrict__ hi,
                const float* __restrict__ n, int* __restrict__ rank,
                int* __restrict__ rid, int B, int n_coef, int n_rings) {
    extern __shared__ float c_s[];
    const int g = blockIdx.y;
    for (int k = threadIdx.x; k < n_coef; k += THREADS)
        c_s[k] = coef[(long long)g * n_coef + k];
    __syncthreads();
    const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (b >= B) return;
    const long long i = (long long)g * B + b;
    rank_math(x[i], c_s, n_coef, lo[g], hi[g], n[g], n_rings, rank + i,
              rid + i);
}

}  // namespace

// x (G, B) f32; coef (G, C) f32; lo/hi/n (G,) f32; rank/rid (G, B) int32.
extern "C" int rankeval(const void* x, const void* coef, const void* lo,
                        const void* hi, const void* n, void* rank, void* rid,
                        int G, int B, int n_coef, int n_rings, void* stream) {
    if (G <= 0 || B <= 0) return 0;
    const dim3 grid((unsigned)((B + THREADS - 1) / THREADS), (unsigned)G);
    rankeval_kernel<<<grid, THREADS, (size_t)n_coef * sizeof(float),
                      (cudaStream_t)stream>>>(
        (const float*)x, (const float*)coef, (const float*)lo,
        (const float*)hi, (const float*)n, (int*)rank, (int*)rid, B, n_coef,
        n_rings);
    return (int)cudaGetLastError();
}
