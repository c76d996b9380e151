// range_filter: squared L2 distance fused with the per-query ball test,
// mask[i, j] = (d2(q_i, p_j) <= r2_i) as uint8, plus int32 hit counts per
// (query, 128-point tile).
//
// Replaces the Pallas kernel repro/kernels/range_filter.py::range_filter_pallas
// (body _range_filter_kernel).  The distance comes from gram.cuh, shared with
// pdist.cu.
//
// What bounds it on an H100: the mask write.  Over the full slot array (64
// queries x 4.6M slots, d = 8) it writes 295 MB of mask and reads 147 MB of
// rows, about 0.13 ms at 3.35 TB/s; the distances never leave the chip.  One
// block per (32 queries, 128-point tile); each warp counts its hits with a
// ballot, and the block adds its four warps' counts, so counts need no
// atomics and are the same in every run.
//
// Padding: callers pad points with the finite 1e30, whose squared norm is
// +inf, so a padded cell is +inf and never a hit.  The clamp in gram.cuh
// keeps a NaN, and NaN <= r2 is false, so a NaN cell is never a hit either.
//
// First, unoptimised version: byte-wide mask stores, no pipelining.
#include <cuda_runtime.h>

#include "gram.cuh"

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BP = 128;         // points per block (= count tile = threads)
constexpr int PSTR = BP + 1;
constexpr int WARPS = BP / 32;

__global__ void __launch_bounds__(BP)
range_filter_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const float* __restrict__ r2,
                    unsigned char* __restrict__ mask, int* __restrict__ cnt,
                    int nq, int np, int d) {
    extern __shared__ float smem[];
    __shared__ int wcnt[BQ][WARPS];
    float* q_s = smem;                  // (BQ, d)
    float* p_s = q_s + BQ * d;          // (d, PSTR)
    float* qn_s = p_s + d * PSTR;       // (BQ,)
    const int j = threadIdx.x;
    const int lane = j & 31;
    const int warp = j >> 5;
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

    const bool live = j < npt;
    const float pn = live ? sq_norm(p_s + j, PSTR, d) : 0.f;
    unsigned char* m = mask + (long long)q0 * np + p0 + j;
    for (int i = 0; i < nqt; ++i) {
        bool hit = false;
        if (live) {
            const float d2 = gram_sq(qn_s[i], pn, q_s + i * d, 1, p_s + j,
                                     PSTR, d);
            hit = d2 <= r2[q0 + i];
            m[(long long)i * np] = (unsigned char)hit;
        }
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) wcnt[i][warp] = __popc(bal);
    }
    __syncthreads();
    if (j < nqt) {
        int c = 0;
        for (int w = 0; w < WARPS; ++w) c += wcnt[j][w];
        cnt[(long long)(q0 + j) * gridDim.x + blockIdx.x] = c;
    }
}

}  // namespace

// q (nq, d), p (np, d), r2 (nq,) f32; mask (nq, np) uint8;
// cnt (nq, ceil(np / 128)) int32.
extern "C" int range_filter(const void* q, const void* p, const void* r2,
                            void* mask, void* cnt, int nq, int np, int d,
                            void* stream) {
    if (nq <= 0 || np <= 0) return 0;
    const size_t smem = (size_t)(BQ * d + d * PSTR + BQ) * sizeof(float);
    if (smem > 48 * 1024 - sizeof(int) * BQ * WARPS) {
        const cudaError_t e = cudaFuncSetAttribute(
            range_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((np + BP - 1) / BP), (unsigned)((nq + BQ - 1) / BQ));
    range_filter_kernel<<<grid, BP, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)p, (const float*)r2,
        (unsigned char*)mask, (int*)cnt, nq, np, d);
    return (int)cudaGetLastError();
}
