// The streaming tile shared by pdist.cu, range_filter.cu and pdist_lp.cu.
//
// The kernels are bound by their output stream: every (query, point) cell
// costs a handful of f32 operations and one store, and the points are read
// once.  So a block of THREADS threads owns BP = THREADS * PPT consecutive
// points and ALL query rows (in chunks of at most BQ rows held in shared
// memory):
//   * each point row is read from device memory once, by one thread, as
//     float4s, and stays in that thread's registers for every query row;
//   * a query row is read from shared memory as broadcast float4s;
//   * a thread owns PPT = 4 consecutive points, so for each query row it
//     stores 4 neighbouring outputs at once, and neighbouring threads store
//     neighbouring addresses.
//
// The arithmetic is gram.cuh's: qn, pn and g summed from k = 0 upwards,
// every product and sum rounded on its own, then (qn + pn) - 2g.  One step
// is left out, and that changes no result: gram.cuh starts g at +0 and adds
// the first product; here g starts at the first product.  The two sums
// differ at most in the sign of a zero (+0 + -0 is +0), the sign survives
// no later addition of a nonzero term, and (qn + pn) - 2g is the same for
// g = +0 and g = -0 (qn + pn >= +0 or NaN), so every distance is the same.
//
// Points<D> holds the coordinates in registers, for a width D known at
// compile time (a multiple of 4, rows 16-B aligned); Points<0> is the
// body for any other width: it reads the coordinates from device memory
// (through L1) for each query row.  NORM (the default) also sums each
// point's squared norm for the Gram bodies; the L1 / L-infinity bodies
// (pdist_lp.cu) pass NORM = false and leave the norms unset.
//
// T is the stored point type: float (the default), __nv_bfloat16 or
// __half (the snapshot's reduced-precision filter plane, read by the sql2
// bodies of pdist.cu and range_filter.cu).  Coords<T> reads it: 16 bytes
// at a time where a register body's row allows it (a bf16 or f16 row of
// d = 8 is one 16-B load), one coordinate at a time otherwise, and
// widens each coordinate to f32 exactly (a bf16 is the high half of its
// f32; __half2float).  Everything after the load is the float body's f32
// arithmetic, unchanged, so a 2-byte plane's distances equal the plain
// version's, which upcasts the points and then runs the same operations.
//
// lp<Op>() is those bodies' loop: Op::step folds a = |q[k] - x[k]| into
// the running value from k = 0 upwards, each difference rounded to
// nearest (__fsub_rn).  The value starts at the first term, not at +0,
// and that changes no result: a is +0 or more, or NaN, so +0 + a is a
// and `a > +0 || a != a ? a : +0` is a.
//
// The tile is a launch parameter (the autotuner's, repro_torch/kernels/
// autotune.py): bp = THREADS * PPT points a block, one of with_threads' four,
// each a template instantiation, and bq, the most query rows a
// chunk, a runtime bound under the shared memory's (query_cap) and, where
// one thread loads each row, under THREADS.  The static tile (bp 512, bq
// 64) is the one every launch took before the tile was a parameter, and
// compiles to the same code.  No result depends on the tile: every output
// is one thread's arithmetic on one (query, point) pair, and a count tile
// is one warp's (range_filter.cu).
#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "gram.cuh"

namespace stream {

// How a stored coordinate of type T is read and widened to f32.
// one(p): the coordinate at p.  load16(r, k, x): the k-th 16 bytes of the
// 16-B aligned row r, PER16 coordinates, into x.
template <class T>
struct Coords {                         // the 2-byte types: bf16, f16
    static_assert(sizeof(T) == 2, "a 2-byte point type");
    static constexpr int PER16 = 8;
    __device__ __forceinline__ static float widen(unsigned short bits);

    __device__ __forceinline__ static float one(const T* p) {
        return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));
    }

    __device__ __forceinline__ static void load16(const T* r, int k,
                                                  float* x) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(r) + k);
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x[2 * i] = widen((unsigned short)(w[i] & 0xffffu));
            x[2 * i + 1] = widen((unsigned short)(w[i] >> 16));
        }
    }
};

template <>
__device__ __forceinline__ float Coords<__nv_bfloat16>::widen(
        unsigned short bits) {
    return __uint_as_float((unsigned)bits << 16);
}

template <>
__device__ __forceinline__ float Coords<__half>::widen(unsigned short bits) {
    return __half2float(__ushort_as_half(bits));
}

template <>
struct Coords<float> {
    static constexpr int PER16 = 4;

    __device__ __forceinline__ static float one(const float* p) {
        return __ldg(p);
    }

    __device__ __forceinline__ static void load16(const float* r, int k,
                                                  float* x) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(r) + k);
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
    }
};

constexpr int PPT = 4;                  // consecutive points per thread
constexpr int SMEM_CAP = 200 * 1024;    // shared memory a chunk may take
static_assert(PPT == 4, "the stores pack four points");

// Calls f(std::integral_constant<int, THREADS>) for the block of bp = THREADS
// * PPT points, bp one of 128, 256, 512 (the static tile) and 1024; any
// other bp is cudaErrorInvalidValue.  Every bp is a multiple of 128, the
// count tile of range_filter.cu (one warp).
template <class F>
int with_threads(int bp, F&& f) {
    switch (bp) {
        case 128: return f(std::integral_constant<int, 32>{});
        case 256: return f(std::integral_constant<int, 64>{});
        case 512: return f(std::integral_constant<int, 128>{});
        case 1024: return f(std::integral_constant<int, 256>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

// A point at or past np gets a NaN norm: every distance to it is NaN, which
// no ball holds; its outputs are never stored.
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

template <int D, bool NORM = true, class T = float>
struct Points {
    static_assert(D > 0 && D % 4 == 0, "register body needs D % 4 == 0");
    using C = Coords<T>;
    float x[PPT][D];
    float n[PPT];

    __device__ __forceinline__ void load(const T* __restrict__ p,
                                         long long pt, long long np, int) {
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const bool live = pt + j < np;
            if (live) {
                const T* r = p + (pt + j) * D;
                if constexpr (D % C::PER16 == 0) {
#pragma unroll
                    for (int k = 0; k < D / C::PER16; ++k)
                        C::load16(r, k, x[j] + k * C::PER16);
                } else {
#pragma unroll
                    for (int k = 0; k < D; ++k) x[j][k] = C::one(r + k);
                }
            } else {
#pragma unroll
                for (int k = 0; k < D; ++k) x[j][k] = 0.f;
            }
            if constexpr (NORM) {
                float s = 0.f;
#pragma unroll
                for (int k = 0; k < D; ++k)
                    s = __fadd_rn(s, __fmul_rn(x[j][k], x[j][k]));
                n[j] = live ? s : nan_f();
            }
        }
    }

    // g[j] = sum_k q[k] * x_j[k] for the query row q in shared memory.
    __device__ __forceinline__ void gram(const float* __restrict__ q, int,
                                         float (&g)[PPT]) const {
        const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll
        for (int k4 = 0; k4 < D / 4; ++k4) {
            const float4 v = q4[k4];
#pragma unroll
            for (int j = 0; j < PPT; ++j) {
                const float* xj = x[j] + 4 * k4;
                g[j] = k4 == 0 ? __fmul_rn(v.x, xj[0])
                               : __fadd_rn(g[j], __fmul_rn(v.x, xj[0]));
                g[j] = __fadd_rn(g[j], __fmul_rn(v.y, xj[1]));
                g[j] = __fadd_rn(g[j], __fmul_rn(v.z, xj[2]));
                g[j] = __fadd_rn(g[j], __fmul_rn(v.w, xj[3]));
            }
        }
    }

    // v[j] = Op over k of |q[k] - x_j[k]| for the query row q in shared
    // memory.
    template <class Op>
    __device__ __forceinline__ void lp(const float* __restrict__ q, int,
                                       float (&v)[PPT]) const {
        const float4* q4 = reinterpret_cast<const float4*>(q);
#pragma unroll
        for (int k4 = 0; k4 < D / 4; ++k4) {
            const float4 w = q4[k4];
#pragma unroll
            for (int j = 0; j < PPT; ++j) {
                const float* xj = x[j] + 4 * k4;
                const float a = fabsf(__fsub_rn(w.x, xj[0]));
                v[j] = k4 == 0 ? a : Op::step(v[j], a);
                v[j] = Op::step(v[j], fabsf(__fsub_rn(w.y, xj[1])));
                v[j] = Op::step(v[j], fabsf(__fsub_rn(w.z, xj[2])));
                v[j] = Op::step(v[j], fabsf(__fsub_rn(w.w, xj[3])));
            }
        }
    }
};

template <bool NORM, class T>
struct Points<0, NORM, T> {
    using C = Coords<T>;
    const T* x;             // the first point's row (clamped in bounds)
    int last;               // the last of the thread's points in range
    int d;
    float n[PPT];

    __device__ __forceinline__ void load(const T* __restrict__ p,
                                         long long pt, long long np, int dd) {
        d = dd;
        last = (int)(np - pt > PPT ? PPT - 1 : np - pt - 1);
        x = p + (last >= 0 ? pt : np - 1) * d;
        if constexpr (NORM) {
#pragma unroll
            for (int j = 0; j < PPT; ++j) {
                // gram.cuh's sq_norm, on the widened coordinates
                n[j] = nan_f();
                if (j > last) continue;
                const T* r = row(j);
                float s = 0.f;
                for (int k = 0; k < d; ++k) {
                    const float v = C::one(r + k);
                    s = __fadd_rn(s, __fmul_rn(v, v));
                }
                n[j] = s;
            }
        }
    }

    // Point j's row, or the last live one's in place of a point past np.
    __device__ __forceinline__ const T* row(int j) const {
        return x + (long long)max(min(j, last), 0) * d;
    }

    __device__ __forceinline__ void gram(const float* __restrict__ q, int,
                                         float (&g)[PPT]) const {
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const T* xj = row(j);
            g[j] = 0.f;
            for (int k = 0; k < d; ++k)
                g[j] = __fadd_rn(g[j], __fmul_rn(q[k], C::one(xj + k)));
        }
    }

    template <class Op>
    __device__ __forceinline__ void lp(const float* __restrict__ q, int,
                                       float (&v)[PPT]) const {
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const T* xj = row(j);
            float a = fabsf(__fsub_rn(q[0], C::one(xj)));
            for (int k = 1; k < d; ++k)
                a = Op::step(a, fabsf(__fsub_rn(q[k], C::one(xj + k))));
            v[j] = a;
        }
    }
};

// Copies query row `row` of q (., d) to o in shared memory and returns its
// squared norm, summed from k = 0 upwards.
template <int D>
__device__ __forceinline__ float load_query(const float* __restrict__ q,
                                            long long row, int d, float* o) {
    float s = 0.f;
    if constexpr (D > 0) {
        const float4* r = reinterpret_cast<const float4*>(q + row * D);
        float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
        for (int k4 = 0; k4 < D / 4; ++k4) {
            const float4 v = __ldg(r + k4);
            o4[k4] = v;
            s = __fadd_rn(s, __fmul_rn(v.x, v.x));
            s = __fadd_rn(s, __fmul_rn(v.y, v.y));
            s = __fadd_rn(s, __fmul_rn(v.z, v.z));
            s = __fadd_rn(s, __fmul_rn(v.w, v.w));
        }
    } else {
        for (int k = 0; k < d; ++k) {
            const float v = __ldg(q + row * d + k);
            o[k] = v;
            s = __fadd_rn(s, __fmul_rn(v, v));
        }
    }
    return s;
}

// Query rows per chunk for width d, with `extra` floats per row beside the
// row itself, at most bq; 0 if not even one row fits.
inline int query_cap(int d, int extra, int bq) {
    const long long rows = SMEM_CAP / ((long long)(d + extra) * sizeof(float));
    return (int)(rows < bq ? rows : bq);
}

// Whether (bp, bq) is a tile the streaming kernels take: bq from 1 to the
// block's threads (one thread loads each query row); bp is checked by
// with_threads.
inline bool tile_ok(int bp, int bq) { return bq >= 1 && bq <= bp / PPT; }

inline bool aligned(const void* ptr, unsigned bytes) {
    return reinterpret_cast<unsigned long long>(ptr) % bytes == 0;
}

// The body width d takes: a register body for the widths the repo launches
// (8: the query path and the builder; 32: the retrieval example's
// embeddings), given 16-B aligned q and p (then every row of p is: a row is
// 16 or 64 B in a 2-byte type, 32 or 128 B in f32); 0 (Points<0>) for any
// other.
inline int body_width(int d, const void* q, const void* p) {
    if ((d == 8 || d == 32) && aligned(q, 16) && aligned(p, 16)) return d;
    return 0;
}

// Dynamic shared memory above the 48 KB default needs the function's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace stream
