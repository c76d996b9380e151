// pdist (sql2): squared L2 distances between every query row and every point
// row, out[i, j] = max((|q_i|^2 + |p_j|^2) - 2 q_i.p_j, 0) in f32.
//
// Replaces the Pallas kernel repro/kernels/pdist.py::pdist_pallas, body
// _pdist_l2_kernel (the l1/linf bodies are not ported yet).
//
// What bounds it on an H100: the output write.  At the kNN distance matrix's
// shape (64 queries x 4.6M slots, d = 8) it writes 1.18 GB and reads 0.15 GB,
// about 0.40 ms at 3.35 TB/s, against under 0.1 ms of f32 arithmetic.  The
// design therefore computes each output once, keeps both operand tiles in
// shared memory, and has neighbouring threads write neighbouring columns so
// every warp's store is one contiguous 128-byte line.
//
// First, unoptimised version: one 32 x 256 output tile per block, no tensor
// cores (so TF32 cannot enter), plain stores, no software pipelining.
#include <cuda_runtime.h>

#include "gram.cuh"

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BP = 256;         // points per block = threads per block
constexpr int PSTR = BP + 1;    // transposed point tile stride (no bank clash)

__global__ void __launch_bounds__(BP)
pdist_sql2_kernel(const float* __restrict__ q, const float* __restrict__ p,
                  float* __restrict__ out, int nq, int np, int d) {
    extern __shared__ float smem[];
    float* q_s = smem;                  // (BQ, d) row-major
    float* p_s = q_s + BQ * d;          // (d, PSTR): point j of the tile at column j
    float* qn_s = p_s + d * PSTR;       // (BQ,)
    const int j = threadIdx.x;
    const long long p0 = (long long)blockIdx.x * BP;
    const int q0 = blockIdx.y * BQ;
    const int nqt = min(BQ, nq - q0);
    const int npt = (int)min((long long)BP, (long long)np - p0);

    for (int e = j; e < nqt * d; e += BP) q_s[e] = q[(long long)q0 * d + e];
    for (int e = j; e < npt * d; e += BP) {
        const int jj = e / d;
        p_s[(e - jj * d) * PSTR + jj] = p[p0 * d + e];
    }
    __syncthreads();
    if (j < nqt) qn_s[j] = sq_norm(q_s + j * d, 1, d);
    __syncthreads();
    if (j >= npt) return;

    const float pn = sq_norm(p_s + j, PSTR, d);
    float* o = out + (long long)q0 * np + p0 + j;
    for (int i = 0; i < nqt; ++i)
        o[(long long)i * np] = gram_sq(qn_s[i], pn, q_s + i * d, 1,
                                       p_s + j, PSTR, d);
}

}  // namespace

// q (nq, d), p (np, d) f32 row-major; out (nq, np) f32.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pdist_sql2(const void* q, const void* p, void* out, int nq,
                          int np, int d, void* stream) {
    if (nq <= 0 || np <= 0) return 0;
    const size_t smem = (size_t)(BQ * d + d * PSTR + BQ) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pdist_sql2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((np + BP - 1) / BP), (unsigned)((nq + BQ - 1) / BQ));
    pdist_sql2_kernel<<<grid, BP, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)p, (float*)out, nq, np, d);
    return (int)cudaGetLastError();
}
