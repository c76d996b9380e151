// pdist (l1, linf): L1 and L-infinity distances between every query row and
// every point row of each of G groups, f32:
//   l1:   out[g, i, j] = sum_k |q[g, i, k] - p[g, j, k]|
//   linf: out[g, i, j] = max_k |q[g, i, k] - p[g, j, k]|
//
// Replaces the Pallas kernel repro/kernels/pdist.py::pdist_pallas (:55),
// bodies _pdist_l1_kernel (:36) and _pdist_linf_kernel (:43): G = 1 is that
// function.  G > 1 is the device builder's launch (build/pivots.py): each
// cluster's m pivots against its own n_max member slots, (K, m, n_max) in one
// launch, where the reference computes a chunk of 16 clusters' (16 m,
// 16 n_max) cross product and keeps its block diagonal.
//
// Order (repeated by the plain PyTorch versions in ../pdist.py): each
// difference rounded to nearest on its own (__fsub_rn), then its absolute
// value; the sum over k = 0 upwards, each sum rounded on its own (__fadd_rn,
// no contraction); the max takes a when `a > m || a != a`, so a NaN operand
// gives NaN as jnp.max does (fmaxf would drop it).  Both start at the first
// term, which equals starting at +0 (stream.cuh).  The max is one PTX
// max.NaN.f32: over values that are +0 or more, or NaN, it gives the select's
// value wherever neither operand is NaN, and NaN wherever either is, as the
// select does.  Kernel and plain version agree bit for bit, NaN cells equal.
//
// What bounds it on an H100: bytes.  At the full-function shape (48 pivot
// rows x 16 clusters' 4.63M member slots, d = 8) it writes 0.89 GB and reads
// 0.15 GB, 0.31 ms at 3.35 TB/s; at two instructions a term (the subtract;
// the add or max, with the absolute value an operand modifier) a cell costs
// about 16, about 0.11 ms of issue.  In the builder's grouped launch (64 x 3
// x 289,664 slots, d = 8) reading the 0.59 GB of padded rows outweighs
// writing the 0.22 GB of distances.  So the design is stream.cuh's: each
// point is read once, into the registers of the thread that owns it with
// three neighbours; a block holds its group's query rows (up to QCAP at a
// time) in shared memory and walks them, and for each row a thread stores
// its four outputs as one 16-byte streaming store where np % 4 == 0 and out
// is 16-B aligned, else, and for the ragged last points, one by one.  A
// block's shared memory is a chunk of whole query rows, query_cap(d, 0) of
// them, so any d up to about 51,000 floats runs.  Blocks are numbered
// group-major along x, so no grid dimension limits G.
#include <climits>

#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

using namespace stream;

struct L1 {
    static __device__ __forceinline__ float step(float acc, float a) {
        return __fadd_rn(acc, a);
    }
};

struct LInf {
    static __device__ __forceinline__ float step(float m, float a) {
        float r;
        asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(m), "f"(a));
        return r;
    }
};

// Query rows [0, nc) of the chunk in shared memory against the thread's
// points; o is the thread's first output of the chunk's first row.  WHOLE:
// the thread's four outputs of a row are in range and 16-B aligned.
template <class Op, bool WHOLE, int D>
__device__ __forceinline__ void lp_rows(const Points<D, false>& pts,
                                        const float* q_s, int dd, int nc,
                                        float* o, long long np,
                                        long long live) {
#pragma unroll 2
    for (int i = 0; i < nc; ++i) {
        float v[PPT];
        pts.template lp<Op>(q_s + i * dd, dd, v);
        float* oi = o + i * np;
        if (WHOLE) {
            __stcs(reinterpret_cast<float4*>(oi),
                   make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
            for (int j = 0; j < PPT; ++j)
                if (j < live) __stcs(oi + j, v[j]);
        }
    }
}

// Block x covers points [(x % nblk) * BP, + BP) of group x / nblk.
template <class Op, int D>
__global__ void __launch_bounds__(THREADS)
pdist_lp_kernel(const float* __restrict__ q, const float* __restrict__ p,
                float* __restrict__ out, int nq, int np, int d, int qcap,
                unsigned nblk, bool vec) {
    extern __shared__ float4 smem[];
    const int dd = D > 0 ? D : d;
    float* q_s = reinterpret_cast<float*>(smem);     // (qcap, dd)
    const unsigned g = blockIdx.x / nblk;
    const long long pt =
        (long long)(blockIdx.x - g * nblk) * BP + PPT * threadIdx.x;
    q += (long long)g * nq * dd;
    p += (long long)g * np * dd;
    out += (long long)g * nq * np;
    Points<D, false> pts;
    pts.load(p, pt, np, dd);
    const long long live = np - pt;         // points of the thread in range
    const bool whole = vec && live >= PPT;

    for (int c0 = 0; c0 < nq; c0 += qcap) {
        const int nc = min(qcap, nq - c0);
        __syncthreads();                    // the previous chunk is done
        const float* qc = q + (long long)c0 * dd;
        for (int e = threadIdx.x; e < nc * dd; e += THREADS)
            q_s[e] = __ldg(qc + e);
        __syncthreads();
        float* o = out + (long long)c0 * np + pt;
        if (whole)
            lp_rows<Op, true>(pts, q_s, dd, nc, o, np, live);
        else if (live > 0)
            lp_rows<Op, false>(pts, q_s, dd, nc, o, np, live);
    }
}

template <class Op, int D>
int launch(const float* q, const float* p, float* out, int G, int nq, int np,
           int d, cudaStream_t stream) {
    const int qcap = min(query_cap(d, 0), nq);
    if (qcap < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)qcap * d * sizeof(float);
    const cudaError_t e = allow_smem(pdist_lp_kernel<Op, D>, smem);
    if (e != cudaSuccess) return (int)e;
    const long long nblk = ((long long)np + BP - 1) / BP;
    if (nblk * G > INT_MAX) return (int)cudaErrorInvalidValue;
    const bool vec = np % PPT == 0 && aligned(out, 16);
    pdist_lp_kernel<Op, D><<<(unsigned)(nblk * G), THREADS, smem, stream>>>(
        q, p, out, nq, np, d, qcap, (unsigned)nblk, vec);
    return (int)cudaGetLastError();
}

template <class Op>
int pdist_lp(const void* q, const void* p, void* out, int G, int nq, int np,
             int d, void* stream) {
    if (G <= 0 || nq <= 0 || np <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (d <= 0)             // an empty sum or max: +0, as the plain versions
        return (int)cudaMemsetAsync(
            out, 0, (size_t)G * nq * np * sizeof(float), s);
    const float *qf = (const float*)q, *pf = (const float*)p;
    float* of = (float*)out;
    switch (body_width(d, q, p)) {
        case 8: return launch<Op, 8>(qf, pf, of, G, nq, np, d, s);
        case 32: return launch<Op, 32>(qf, pf, of, G, nq, np, d, s);
        default: return launch<Op, 0>(qf, pf, of, G, nq, np, d, s);
    }
}

}  // namespace

// q (G, nq, d), p (G, np, d) f32 row-major; out (G, nq, np) f32.  Each
// returns the CUDA error code of the launch (0 on success).
extern "C" int pdist_l1(const void* q, const void* p, void* out, int G,
                        int nq, int np, int d, void* stream) {
    return pdist_lp<L1>(q, p, out, G, nq, np, d, stream);
}

extern "C" int pdist_linf(const void* q, const void* p, void* out, int G,
                          int nq, int np, int d, void* stream) {
    return pdist_lp<LInf>(q, p, out, G, nq, np, d, stream);
}
