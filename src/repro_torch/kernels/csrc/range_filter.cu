// range_filter: squared L2 distance fused with the per-query ball test,
// mask[i, j] = (d2(q_i, p_j) <= r2_i) as uint8, plus int32 hit counts per
// (query, 128-point tile).
//
// Replaces the Pallas kernel repro/kernels/range_filter.py::range_filter_pallas
// (:35), body _range_filter_kernel (:20).  The distance is gram.cuh's, shared
// with pdist.cu and fused.cu, and the mask equals the plain version's bit for
// bit.
//
// What bounds it on an H100: instruction issue, not bytes.  Over the full
// slot array (64 queries x 4.6M slots, d = 8) it writes 295 MB of mask and
// reads 147 MB of rows, 0.13 ms at 3.35 TB/s; the distances never leave the
// chip.  But the fixed f32 operation order (no FMA: d products and d - 1
// sums for g, then qn + pn, 2g and the difference) and the test cost about
// 20 instructions a cell, about 0.18 ms of issue at the card's clock.  So the
// design (stream.cuh) spends as few other instructions as it can, and keeps
// enough independent work in flight to hide the f32 latency:
//   * each point is read once, into the registers of the thread that owns it
//     with three neighbours; a block holds all query rows with their norms
//     and r2 (up to bq at a time) in shared memory;
//   * for each row a thread packs its four mask bytes into one 4-byte
//     streaming store (a warp writes 128 contiguous bytes);
//   * a warp is one 128-point count tile: one warp reduction adds its lanes'
//     hits, lane l keeps row l's count and the lanes store 32 rows' counts
//     together, so counts need no shared memory or atomics and are the same
//     in every run;
//   * the clamp is folded into the threshold (r2_test); rows are unrolled by
//     4 and the d = 8 body is held to 80 registers, so 768 threads (6 blocks
//     of 128 at the static tile) share an SM.
// Mask rows whose start is not 4-B aligned (np % 4 != 0) and the ragged last
// points are stored byte by byte.
//
// Padding: callers pad points with the finite 1e30, whose squared norm is
// +inf, so a padded cell is +inf and never a hit.  A NaN distance passes no
// test, so a NaN cell is never a hit either; points past np get a NaN norm
// and so never count.
//
// Points may also be bf16 or f16 (the snapshot's reduced-precision filter
// plane; queries and r2 stay f32): range_filter_bf16 and range_filter_f16
// are the same template on the stored type, which stream.cuh's Coords
// widens to f32 exactly as it loads a row, so mask and counts equal the
// plain version's on the upcast points.  In f16 the callers' pad row is
// +inf itself; its cells are +inf or NaN, which no finite ball holds.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "stream.cuh"

namespace {

using namespace stream;

constexpr int TILE = 32 * PPT;          // points per count tile: one warp
static_assert(TILE == 128, "the wrappers' count tile is 128 points");

// The test d2 <= r2 on the unclamped distance v against r2e = (r2 < 0 ? NaN
// : r2).  It decides as (v < 0 ? 0 : v) <= r2 does: for r2 >= 0 a negative v
// passes both (0 <= r2 and v < 0 <= r2), any other v is its own clamp; a
// negative r2 holds no clamped distance and NaN holds none; a NaN v passes
// neither.  So the clamp costs nothing here.
__device__ __forceinline__ float r2_test(float r2) {
    return r2 < 0.f ? nan_f() : r2;
}

// Query rows [0, nc) of the chunk against the thread's points: m is the
// thread's first mask byte of the chunk's first row, c the warp's count of
// it.  WHOLE: the thread's four bytes of a row are in range and 4-B aligned.
// Each row's count is one warp reduction of the lanes' hits; lane l keeps
// row i0 + l's, and every 32 rows the lanes store theirs together.
template <bool WHOLE, int D, class T>
__device__ __forceinline__ void filter_rows(
        const Points<D, true, T>& pts, const float* q_s, const float2* qr_s,
        int dd, int nc, unsigned char* m, int* c, long long np,
        long long ntiles, long long live, int lane) {
    for (int i0 = 0; i0 < nc; i0 += 32) {
        const int n32 = min(32, nc - i0);
        unsigned mine = 0;
        unsigned char* mi = m + i0 * np;
#pragma unroll 4
        for (int ii = 0; ii < n32; ++ii, mi += np) {
            const int i = i0 + ii;
            float g[PPT];
            pts.gram(q_s + i * dd, dd, g);
            const float2 qr = qr_s[i];
            const unsigned w =
                (gram_raw(qr.x, pts.n[0], g[0]) <= qr.y ? 0x1u : 0u)
                | (gram_raw(qr.x, pts.n[1], g[1]) <= qr.y ? 0x100u : 0u)
                | (gram_raw(qr.x, pts.n[2], g[2]) <= qr.y ? 0x10000u : 0u)
                | (gram_raw(qr.x, pts.n[3], g[3]) <= qr.y ? 0x1000000u : 0u);
            if (WHOLE) {
                __stcs(reinterpret_cast<unsigned*>(mi), w);
            } else {
#pragma unroll
                for (int j = 0; j < PPT; ++j)
                    if (j < live) mi[j] = (unsigned char)((w >> (8 * j)) & 1u);
            }
            const unsigned total = __reduce_add_sync(0xffffffffu, __popc(w));
            if (ii == lane) mine = total;
        }
        if (lane < n32) c[(i0 + lane) * ntiles] = (int)mine;
    }
}

// The register body at d = 8 is held to 768 threads an SM (6 blocks of 128;
// at most 80 registers): more warps to hide the latency of its dependent f32
// chains.
template <class T, int D, int THREADS>
__global__ void __launch_bounds__(THREADS, D == 8 ? 768 / THREADS : 1)
range_filter_kernel(const float* __restrict__ q, const T* __restrict__ p,
                    const float* __restrict__ r2,
                    unsigned char* __restrict__ mask, int* __restrict__ cnt,
                    int nq, int np, int d, int qcap, bool vec) {
    extern __shared__ float4 smem[];
    const int dd = D > 0 ? D : d;
    float2* qr_s = reinterpret_cast<float2*>(smem);   // (qcap,) of (qn, r2e)
    float* q_s = reinterpret_cast<float*>(qr_s + qcap);   // (qcap, dd)
    const int lane = threadIdx.x & 31;
    const long long pt =
        (long long)blockIdx.x * (THREADS * PPT) + PPT * threadIdx.x;
    const long long tile = pt / TILE;
    const long long ntiles = ((long long)np + TILE - 1) / TILE;
    Points<D, true, T> pts;
    pts.load(p, pt, np, dd);
    const long long live = np - pt;         // points of the thread in range
    const bool whole = vec && live >= PPT;

    for (int c0 = 0; c0 < nq; c0 += qcap) {
        const int nc = min(qcap, nq - c0);
        __syncthreads();                    // the previous chunk is done
        if ((int)threadIdx.x < nc) {
            const int i = c0 + threadIdx.x;
            const float qn = load_query<D>(q, i, dd, q_s + threadIdx.x * dd);
            qr_s[threadIdx.x] = make_float2(qn, r2_test(__ldg(r2 + i)));
        }
        __syncthreads();
        if (tile >= ntiles) continue;       // the whole warp lies past np
        unsigned char* m = mask + (long long)c0 * np + pt;
        int* c = cnt + (long long)c0 * ntiles + tile;
        if (__all_sync(0xffffffffu, whole))
            filter_rows<true>(pts, q_s, qr_s, dd, nc, m, c, np, ntiles, live,
                              lane);
        else
            filter_rows<false>(pts, q_s, qr_s, dd, nc, m, c, np, ntiles,
                               live, lane);
    }
}

template <class T, int D>
int launch(const float* q, const T* p, const float* r2,
           unsigned char* mask, int* cnt, int nq, int np, int d, int bp,
           int bq, cudaStream_t stream) {
    if (!tile_ok(bp, bq)) return (int)cudaErrorInvalidValue;
    const int qcap = query_cap(d, 2, bq);
    if (qcap < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)qcap * (d + 2) * sizeof(float);
    const bool vec = np % PPT == 0 && aligned(mask, PPT);
    const unsigned grid = (unsigned)((np + bp - 1) / bp);
    return with_threads(bp, [&](auto threads) {
        constexpr int TH = decltype(threads)::value;
        const cudaError_t e = allow_smem(range_filter_kernel<T, D, TH>, smem);
        if (e != cudaSuccess) return (int)e;
        range_filter_kernel<T, D, TH><<<grid, TH, smem, stream>>>(
            q, p, r2, mask, cnt, nq, np, d, qcap, vec);
        return (int)cudaGetLastError();
    });
}

template <class T>
int range_filter_of(const void* q, const void* p, const void* r2, void* mask,
                    void* cnt, int nq, int np, int d, int bp, int bq,
                    void* stream) {
    if (nq <= 0 || np <= 0) return 0;
    const float *qf = (const float*)q, *rf = (const float*)r2;
    const T* pt = (const T*)p;
    unsigned char* mf = (unsigned char*)mask;
    int* cf = (int*)cnt;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (body_width(d, q, p)) {
        case 8:
            return launch<T, 8>(qf, pt, rf, mf, cf, nq, np, d, bp, bq, s);
        case 32:
            return launch<T, 32>(qf, pt, rf, mf, cf, nq, np, d, bp, bq, s);
        default:
            return launch<T, 0>(qf, pt, rf, mf, cf, nq, np, d, bp, bq, s);
    }
}

}  // namespace

// q (nq, d) f32, p (np, d) in f32 / bf16 / f16, r2 (nq,) f32; mask (nq, np)
// uint8; cnt (nq, ceil(np / 128)) int32; the tile (bp, bq) as stream.cuh
// takes it.
extern "C" int range_filter(const void* q, const void* p, const void* r2,
                            void* mask, void* cnt, int nq, int np, int d,
                            int bp, int bq, void* stream) {
    return range_filter_of<float>(q, p, r2, mask, cnt, nq, np, d, bp, bq,
                                  stream);
}

extern "C" int range_filter_bf16(const void* q, const void* p,
                                 const void* r2, void* mask, void* cnt,
                                 int nq, int np, int d, int bp, int bq,
                                 void* stream) {
    return range_filter_of<__nv_bfloat16>(q, p, r2, mask, cnt, nq, np, d, bp,
                                          bq, stream);
}

extern "C" int range_filter_f16(const void* q, const void* p, const void* r2,
                                void* mask, void* cnt, int nq, int np, int d,
                                int bp, int bq, void* stream) {
    return range_filter_of<__half>(q, p, r2, mask, cnt, nq, np, d, bp, bq,
                                   stream);
}
