// pdist (sql2): squared L2 distances between every query row and every point
// row, out[i, j] = max((|q_i|^2 + |p_j|^2) - 2 q_i.p_j, 0) in f32.
//
// Replaces the Pallas kernel repro/kernels/pdist.py::pdist_pallas (:55),
// body _pdist_l2_kernel (:25); the l1/linf bodies are pdist_lp.cu.
//
// What bounds it on an H100: the output write.  At the kNN distance matrix's
// shape (64 queries x 4.6M slots, d = 8) it writes 1.18 GB and reads 0.15 GB,
// 0.40 ms at 3.35 TB/s; the fixed f32 operation order (no FMA) costs about
// 2d + 4 = 20 instructions an output, under 0.2 ms of issue at the card's
// clock.  So the design (stream.cuh) streams the output: each point is read
// once, by the thread that owns it with three neighbours, into registers; a
// block holds all query rows (up to bq at a time) in shared memory and
// walks them, and for each row a thread stores its four outputs as one
// 16-byte streaming store (st.global.cs: the matrix does not fit the 50 MB
// L2 and is not read back here), neighbouring threads on neighbouring
// addresses.  A row starts 16-B aligned only when np % 4 == 0 (the main
// path's 4,607,872 and the planner's 192 are); otherwise, and for the
// ragged last points, the thread stores its outputs one by one.
//
// The arithmetic is gram.cuh's, bit for bit (the plain version and the
// fused pdist_rankeval repeat it).
//
// Points may also be bf16 or f16 (the snapshot's reduced-precision filter
// plane; queries stay f32): pdist_sql2_bf16 and pdist_sql2_f16 are the same
// template on the stored type, which stream.cuh's Coords widens to f32
// exactly as it loads a row (a d = 8 row is one 16-B load), so each output
// equals the plain version's on the upcast points.  The 2-byte plane halves
// the point bytes, which saves little here: at the kNN shape 1,253 MB move
// in place of 1,327 MB, most of them the output write.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

using namespace stream;

// Query rows [0, nc) of the chunk in shared memory against the thread's
// points; o is the thread's first output of the chunk's first row.  WHOLE:
// the thread's four outputs of a row are in range and 16-B aligned.
template <bool WHOLE, int D, class T>
__device__ __forceinline__ void pdist_rows(const Points<D, true, T>& pts,
                                           const float* q_s,
                                           const float* qn_s, int dd, int nc,
                                           float* o, long long np,
                                           long long live) {
#pragma unroll 2
    for (int i = 0; i < nc; ++i) {
        float g[PPT];
        pts.gram(q_s + i * dd, dd, g);
        const float qn = qn_s[i];
        float v[PPT];
#pragma unroll
        for (int j = 0; j < PPT; ++j) v[j] = gram_finish(qn, pts.n[j], g[j]);
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

template <class T, int D, int THREADS>
__global__ void __launch_bounds__(THREADS)
pdist_sql2_kernel(const float* __restrict__ q, const T* __restrict__ p,
                  float* __restrict__ out, int nq, int np, int d, int qcap,
                  bool vec) {
    extern __shared__ float4 smem[];
    const int dd = D > 0 ? D : d;
    float* q_s = reinterpret_cast<float*>(smem);     // (qcap, dd)
    float* qn_s = q_s + qcap * dd;                   // (qcap,)
    const long long pt =
        (long long)blockIdx.x * (THREADS * PPT) + PPT * threadIdx.x;
    Points<D, true, T> pts;
    pts.load(p, pt, np, dd);
    const long long live = np - pt;         // points of the thread in range
    const bool whole = vec && live >= PPT;

    for (int c0 = 0; c0 < nq; c0 += qcap) {
        const int nc = min(qcap, nq - c0);
        __syncthreads();                    // the previous chunk is done
        if ((int)threadIdx.x < nc)
            qn_s[threadIdx.x] = load_query<D>(q, c0 + threadIdx.x, dd,
                                              q_s + threadIdx.x * dd);
        __syncthreads();
        float* o = out + (long long)c0 * np + pt;
        if (whole)
            pdist_rows<true>(pts, q_s, qn_s, dd, nc, o, np, live);
        else if (live > 0)
            pdist_rows<false>(pts, q_s, qn_s, dd, nc, o, np, live);
    }
}

template <class T, int D>
int launch(const float* q, const T* p, float* out, int nq, int np, int d,
           int bp, int bq, cudaStream_t stream) {
    if (!tile_ok(bp, bq)) return (int)cudaErrorInvalidValue;
    const int qcap = query_cap(d, 1, bq);
    if (qcap < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)qcap * (d + 1) * sizeof(float);
    const bool vec = np % 4 == 0 && aligned(out, 16);
    const unsigned grid = (unsigned)((np + bp - 1) / bp);
    return with_threads(bp, [&](auto threads) {
        constexpr int TH = decltype(threads)::value;
        const cudaError_t e = allow_smem(pdist_sql2_kernel<T, D, TH>, smem);
        if (e != cudaSuccess) return (int)e;
        pdist_sql2_kernel<T, D, TH><<<grid, TH, smem, stream>>>(
            q, p, out, nq, np, d, qcap, vec);
        return (int)cudaGetLastError();
    });
}

template <class T>
int pdist_sql2_of(const void* q, const void* p, void* out, int nq, int np,
                  int d, int bp, int bq, void* stream) {
    if (nq <= 0 || np <= 0) return 0;
    const float* qf = (const float*)q;
    const T* pt = (const T*)p;
    float* of = (float*)out;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (body_width(d, q, p)) {
        case 8: return launch<T, 8>(qf, pt, of, nq, np, d, bp, bq, s);
        case 32: return launch<T, 32>(qf, pt, of, nq, np, d, bp, bq, s);
        default: return launch<T, 0>(qf, pt, of, nq, np, d, bp, bq, s);
    }
}

}  // namespace

// q (nq, d) f32 and p (np, d) row-major, p in f32 / bf16 / f16; out (nq,
// np) f32; the tile (bp, bq) as stream.cuh takes it.  Each returns the CUDA
// error code of the launch (0 on success).
extern "C" int pdist_sql2(const void* q, const void* p, void* out, int nq,
                          int np, int d, int bp, int bq, void* stream) {
    return pdist_sql2_of<float>(q, p, out, nq, np, d, bp, bq, stream);
}

extern "C" int pdist_sql2_bf16(const void* q, const void* p, void* out,
                               int nq, int np, int d, int bp, int bq,
                               void* stream) {
    return pdist_sql2_of<__nv_bfloat16>(q, p, out, nq, np, d, bp, bq,
                                        stream);
}

extern "C" int pdist_sql2_f16(const void* q, const void* p, void* out,
                              int nq, int np, int d, int bp, int bq,
                              void* stream) {
    return pdist_sql2_of<__half>(q, p, out, nq, np, d, bp, bq, stream);
}
