// pdist (l1, linf): L1 and L-infinity distances between every query row and
// every point row, f32:
//   l1:   out[i, j] = sum_k |q_ik - p_jk|
//   linf: out[i, j] = max_k |q_ik - p_jk|
//
// Replaces the Pallas kernel repro/kernels/pdist.py::pdist_pallas (:55),
// bodies _pdist_l1_kernel (:36) and _pdist_linf_kernel (:43).  Those
// broadcast a (bq <= 32, bp, d) difference tile in VMEM; here no such tile
// exists: a block keeps a tile of q and a transposed tile of p in shared
// memory, as pdist.cu does, and each thread owns one point column and walks
// the block's queries, so neighbouring threads store neighbouring outputs.
//
// Order (repeated by the plain PyTorch versions in ../pdist.py): the sum runs
// over k = 0 upwards, every difference and sum rounded to nearest on its own
// (__fsub_rn, __fadd_rn, so no contraction); the max starts at 0 and takes
// a when `a > m || a != a`, so a NaN operand gives NaN as jnp.max does
// (fmaxf would drop it).  Kernel and plain version agree bit for bit.
//
// What bounds it on an H100: the output write.  At the device builder's
// shape (48 pivot rows x 16 clusters' member slots, up to 4.63M, d = 8) it
// writes up to 0.89 GB against 3 d f32 operations (subtract, absolute value,
// add or max) per cell, about 0.27 ms of memory time and 0.08 ms of
// arithmetic at the published peaks.  So each output is computed once and
// every warp's store is one contiguous 128-byte line.
//
// First, unoptimised version: one 32 x 256 output tile per block, plain
// stores, no software pipelining.
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;          // query rows per block
constexpr int BP = 256;         // points per block = threads per block
constexpr int PSTR = BP + 1;    // transposed point tile stride (no bank clash)

struct L1 {
    static __device__ __forceinline__ float step(float acc, float a) {
        return __fadd_rn(acc, a);
    }
};

struct LInf {
    static __device__ __forceinline__ float step(float acc, float a) {
        return (a > acc || a != a) ? a : acc;
    }
};

template <class Op>
__global__ void __launch_bounds__(BP)
pdist_lp_kernel(const float* __restrict__ q, const float* __restrict__ p,
                float* __restrict__ out, int nq, int np, int d) {
    extern __shared__ float smem[];
    float* q_s = smem;                  // (BQ, d) row-major
    float* p_s = q_s + BQ * d;          // (d, PSTR): point j of the tile at column j
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
    if (j >= npt) return;

    float* o = out + (long long)q0 * np + p0 + j;
    for (int i = 0; i < nqt; ++i) {
        const float* qi = q_s + i * d;
        float acc = 0.f;
        for (int k = 0; k < d; ++k)
            acc = Op::step(acc, fabsf(__fsub_rn(qi[k], p_s[k * PSTR + j])));
        o[(long long)i * np] = acc;
    }
}

template <class Op>
int launch(const void* q, const void* p, void* out, int nq, int np, int d,
           void* stream) {
    if (nq <= 0 || np <= 0) return 0;
    const size_t smem = (size_t)(BQ * d + d * PSTR) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pdist_lp_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((np + BP - 1) / BP), (unsigned)((nq + BQ - 1) / BQ));
    pdist_lp_kernel<Op><<<grid, BP, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)p, (float*)out, nq, np, d);
    return (int)cudaGetLastError();
}

}  // namespace

// q (nq, d), p (np, d) f32 row-major; out (nq, np) f32.  Each returns the
// CUDA error code of the launch (0 on success).
extern "C" int pdist_l1(const void* q, const void* p, void* out, int nq,
                        int np, int d, void* stream) {
    return launch<L1>(q, p, out, nq, np, d, stream);
}

extern "C" int pdist_linf(const void* q, const void* p, void* out, int nq,
                          int np, int d, void* stream) {
    return launch<LInf>(q, p, out, nq, np, d, stream);
}
