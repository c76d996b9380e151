// rankeval: evaluate each (cluster, pivot) group's Chebyshev rank model on a
// (G, B) block of distances and derive ring ids, rank/rid (G, B) int32.
//
// Replaces the Pallas kernel repro/kernels/rankeval.py::rankeval_pallas
// (:69; body _rankeval_kernel :58 using rank_math :29).  The arithmetic
// lives in rank_math.cuh, shared with fused.cu.
//
// What bounds it on an H100: bytes.  At the snapshot's certification shape
// (192 groups x 72k sorted distances, C = 9) it reads 55 MB and writes
// 110 MB, about 0.05 ms at 3.35 TB/s.  A value costs about 70 SASS
// instructions (two IEEE divisions, the Clenshaw chain of 3 per
// coefficient, the clips, rounds and conversions, addresses and bounds),
// about 0.03 ms of issue at that shape, so the design spends no instruction
// a value does not need and keeps enough warps to overlap the rest:
// - the group's constants (rank_group) and coefficients are staged once a
//   block in shared memory, by the block's first threads, while the block's
//   loads of x are in flight; C is a template parameter (1..16, the runtime
//   loop for any other C), so Clenshaw is unrolled with the coefficients in
//   registers;
// - a thread takes two quads, 8 values: 16-byte loads of x and 16-byte
//   streaming stores of rank and rid where x, rank and rid are 16-B aligned.
//   Quads follow the 16-B grid of the row's addresses, so with B % 4 != 0 a
//   row's first and last quads are partial and go value by value; so does
//   every quad when x is not 16-B aligned;
// - blocks of 128 threads (1,024 values): at 48 registers an SM holds ten,
//   whose load, compute and store phases overlap better than those of five
//   blocks of 256 (faster in a sweep of block sizes on the card).  The
//   block is a launch parameter (the autotuner's tile bb = values a block =
//   THREADS * 8: 512, 1,024, the static tile, or 2,048), one template
//   instantiation each; a block always covers one group's values, and
//   every value's rank is one thread's arithmetic, so no result depends on
//   it;
// - block x covers tile x % tiles of group x / tiles (group-major along x),
//   so no grid dimension caps G.
#include <climits>

#include <cuda_runtime.h>

#include "rank_math.cuh"

namespace {

constexpr int QPT = 2;                  // quads a thread
constexpr int VPT = 4 * QPT;            // values a thread

template <int C, int THREADS>
__global__ void __launch_bounds__(THREADS)
rankeval_kernel(const float* __restrict__ x, const float* __restrict__ coef,
                const float* __restrict__ lo, const float* __restrict__ hi,
                const float* __restrict__ n, int* __restrict__ rank,
                int* __restrict__ rid, int B, int n_coef, int n_rings,
                unsigned tiles, bool vec) {
    constexpr int TILE = THREADS * QPT;         // quads a block
    extern __shared__ float c_s[];              // the group's n_coef
    __shared__ RankGroup grp_s;
    const unsigned g = blockIdx.x / tiles;
    const long long row = (long long)g * B;
    // the row's first value's place in its 16-B quad; quad j of the row
    // holds its values [4j - phase, 4j - phase + 4) that lie in [0, B)
    const int phase = (int)(row & 3);
    long long e0[QPT];                          // each quad's first value
#pragma unroll
    for (int s = 0; s < QPT; ++s)
        e0[s] = 4 * ((long long)(blockIdx.x - g * tiles) * TILE
                     + s * THREADS + threadIdx.x) - phase;

    float v[VPT];
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
        if (vec && e0[s] >= 0 && e0[s] + 4 <= B) {
            const float4 f =
                __ldcs(reinterpret_cast<const float4*>(x + row + e0[s]));
            v[4 * s] = f.x;
            v[4 * s + 1] = f.y;
            v[4 * s + 2] = f.z;
            v[4 * s + 3] = f.w;
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const long long e = e0[s] + i;
                v[4 * s + i] = e >= 0 && e < B ? __ldcs(x + row + e) : 0.f;
            }
        }
    }
    for (int k = threadIdx.x; k < n_coef; k += THREADS)
        c_s[k] = coef[(long long)g * n_coef + k];
    if (threadIdx.x == 0) grp_s = rank_group(lo[g], hi[g], n[g], n_rings);
    __syncthreads();

    float c[C > 0 ? C : 1];
#pragma unroll
    for (int k = 0; k < C; ++k) c[k] = c_s[k];
    const RankGroup gr = grp_s;
    int rk[VPT], rd[VPT];
    rank_math<C, VPT>(v, C > 0 ? c : c_s, n_coef, gr, n_rings, rk, rd);

#pragma unroll
    for (int s = 0; s < QPT; ++s) {
        if (vec && e0[s] >= 0 && e0[s] + 4 <= B) {
            __stcs(reinterpret_cast<int4*>(rank + row + e0[s]),
                   make_int4(rk[4 * s], rk[4 * s + 1], rk[4 * s + 2],
                             rk[4 * s + 3]));
            __stcs(reinterpret_cast<int4*>(rid + row + e0[s]),
                   make_int4(rd[4 * s], rd[4 * s + 1], rd[4 * s + 2],
                             rd[4 * s + 3]));
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const long long e = e0[s] + i;
                if (e >= 0 && e < B) {
                    __stcs(rank + row + e, rk[4 * s + i]);
                    __stcs(rid + row + e, rd[4 * s + i]);
                }
            }
        }
    }
}

inline bool aligned16(const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int C, int THREADS>
int launch(const float* x, const float* coef, const float* lo,
           const float* hi, const float* n, int* rank, int* rid, int G, int B,
           int n_coef, int n_rings, cudaStream_t stream) {
    constexpr int TILE = THREADS * QPT;
    // the quads a row spans at most (phase 3), in whole tiles
    const long long quads = ((long long)B + 6) / 4;
    const long long tiles = (quads + TILE - 1) / TILE;
    if (tiles * G > INT_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)n_coef * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            rankeval_kernel<C, THREADS>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const bool vec = aligned16(x) && aligned16(rank) && aligned16(rid);
    rankeval_kernel<C, THREADS>
        <<<(unsigned)(tiles * G), THREADS, smem, stream>>>(
            x, coef, lo, hi, n, rank, rid, B, n_coef, n_rings,
            (unsigned)tiles, vec);
    return (int)cudaGetLastError();
}

// The block of bb = THREADS * VPT values: 512, 1,024 or 2,048.
template <int C>
int launch_bb(const float* x, const float* coef, const float* lo,
              const float* hi, const float* n, int* rank, int* rid, int G,
              int B, int n_coef, int n_rings, int bb, cudaStream_t stream) {
    switch (bb) {
        case 512:
            return launch<C, 64>(x, coef, lo, hi, n, rank, rid, G, B, n_coef,
                                 n_rings, stream);
        case 1024:
            return launch<C, 128>(x, coef, lo, hi, n, rank, rid, G, B,
                                  n_coef, n_rings, stream);
        case 2048:
            return launch<C, 256>(x, coef, lo, hi, n, rank, rid, G, B,
                                  n_coef, n_rings, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// x (G, B) f32; coef (G, C) f32; lo/hi/n (G,) f32; rank/rid (G, B) int32;
// bb values a block.
extern "C" int rankeval(const void* x, const void* coef, const void* lo,
                        const void* hi, const void* n, void* rank, void* rid,
                        int G, int B, int n_coef, int n_rings, int bb,
                        void* stream) {
    if (G <= 0 || B <= 0) return 0;
    if (n_coef <= 0) return (int)cudaErrorInvalidValue;
    const float *xf = (const float*)x, *cf = (const float*)coef;
    const float *lf = (const float*)lo, *hf = (const float*)hi;
    const float* nf = (const float*)n;
    int *rk = (int*)rank, *rd = (int*)rid;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (n_coef) {
#define RANKEVAL_CASE(c)                                                  \
    case c:                                                               \
        return launch_bb<c>(xf, cf, lf, hf, nf, rk, rd, G, B, n_coef,      \
                            n_rings, bb, s);
        RANKEVAL_CASE(1) RANKEVAL_CASE(2) RANKEVAL_CASE(3) RANKEVAL_CASE(4)
        RANKEVAL_CASE(5) RANKEVAL_CASE(6) RANKEVAL_CASE(7) RANKEVAL_CASE(8)
        RANKEVAL_CASE(9) RANKEVAL_CASE(10) RANKEVAL_CASE(11) RANKEVAL_CASE(12)
        RANKEVAL_CASE(13) RANKEVAL_CASE(14) RANKEVAL_CASE(15) RANKEVAL_CASE(16)
#undef RANKEVAL_CASE
        default:
            return launch_bb<0>(xf, cf, lf, hf, nf, rk, rd, G, B, n_coef,
                                n_rings, bb, s);
    }
}
