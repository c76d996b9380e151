// flash_attention: GQA online-softmax attention, causal or not.
//   q (B, Hq, Sq, D), k and v (B, Hk, Sk, D), Hq % Hk == 0, f32 or bf16;
//   out (B, Hq, Sq, D) in q's type.  q head h reads kv head h / (Hq / Hk):
//   K and V are never repeated in memory.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (:74), body _flash_kernel (:26).  That kernel walks
// a (b, h, q block, kv block) grid in order and carries m, l and the output
// block from one kv step to the next in VMEM.  Blocks on the H100 run in no
// order, so here one thread block owns a (b, h, q tile) and walks its kv
// tiles in a loop, keeping the running m, l and output in registers.
//
// Function, as _flash_kernel: per kv tile m_new = max(m, max_j s),
// p = exp(s - m_new), alpha = exp(m - m_new), l = alpha * l + sum(p),
// acc = acc * alpha + p.V; at the end out = acc / max(l, 1e-30), rounded
// once to the output type.  A masked score is -1e30 (not -inf, so the
// exponent stays finite).  The causal mask is qpos >= kpos, both counted
// from 0 at the top left (flash_attention.py:50-52); keys at or beyond kv_len
// are masked; kv tiles wholly above the diagonal (and, in the tensor-core
// body, wholly at or beyond kv_len) are skipped, which changes nothing (such
// a tile gives p = 0 and alpha = 1 exactly).  The plain PyTorch version
// (../ref.py flash_attention_ref) runs the same recurrence over 128-wide kv
// blocks.
//
// Two bodies; launch<T> picks one by type and head width:
//
// * bf16, D in {64, 128}: flash_tc_kernel, on Hopper's tensor cores.  What
//   bounds it: operations.  At a Llama-3-8B prefill (B 4, Hq 32, Hk 8, S 2048,
//   D 128, causal, kv_len 2000) the function needs 4 D flops for each live
//   (q, k) pair, 137 GFLOP, against 168 MB in and out; this body does Q K^T in
//   one bf16 pass and P V in two, 1.5 x 137 GFLOP at 989 TFLOP/s = 0.21 ms,
//   against 0.05 ms of memory time.  Design: one block per (b, h, 128-row q
//   tile), two consumer warpgroups of 64 rows and one producer warp, with
//   the last q tile (the most kv tiles) first.  The producer loads Q once and
//   K and V tiles (128 keys) into a 2-stage ring with TMA (128-byte swizzle,
//   boxes of 64 columns), completion on mbarriers; the consumers release a
//   stage through a second barrier.  S = Q K^T is one wgmma m64n128k16 chain
//   from shared memory, exact products of the bf16 operands in the f32
//   accumulator; 1/sqrt(D) times log2(e) then scales S in f32, and the
//   online softmax runs on the accumulator fragment (a row's 128 scores lie
//   on the 4 lanes of a quad) with p = 2^(s - m) on the SFU's ex2: an
//   argument error of ~1000 x 2^-24 at the largest scores, ~6e-5 relative in
//   p.  Mask arithmetic runs only on the diagonal tile and the one holding
//   kv_len.  P stays f32-valued: it splits in registers into P_hi = bf16(P)
//   and P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V is two wgmma chains
//   with A from registers (the S accumulator's layout is the A fragment's)
//   and V read MN-major through the descriptor's transpose bit, into one f32
//   accumulator; the split's residual is ~2^-16 of P, far under the output's
//   bf16 ulp.  (Rounding P once to bf16, as fused attention libraries do,
//   is a coarser function: at random Llama-width weights scores have a
//   standard deviation of ~250 and rows are near one-hot.)  O is rescaled
//   by alpha before the P V chain is issued.  At the Llama layers its
//   outputs lie within half of rtol = atol = 2^-7 of the f64 answer, nearer
//   it than the plain version, whose sequential f32 dot products part from
//   it where leading keys nearly tie (PERF.md).  The epilogue divides by
//   max(l, 1e-30), rounds to bf16, stages each warpgroup's rows in its own
//   (now unread) part of the Q tile and writes 16 bytes a thread.
//   Registers: S 64, O 64 (D 128), P hi and lo 64; setmaxnreg gives the
//   consumers 232 and the producer 40.  Not done here: sharing one K/V load
//   across a kv head's q heads (L2 serves it), ping-pong of softmax and
//   GEMM within a warpgroup, a persistent grid.
//
// * f32 (every D) and bf16 with D in {16, 32}: flash_kernel, f32 math on the
//   CUDA cores.  q is cast to f32 and scaled by 1/sqrt(D) in f32, dot
//   products are explicit f32 fused multiply-adds (the flags forbid
//   contraction everywhere else), exp is expf.  Each thread owns 4 rows and a
//   4 x 4 score tile of a 64-row q tile and 64-key kv tile, read as float4s
//   from shared-memory tiles whose rows are padded by 4 floats so a warp's
//   float4 reads hit distinct banks.  Bounded at the f32 rate of the CUDA
//   cores (67 TFLOP/s); it serves the f32 checks, whose bar a bf16 pass
//   would miss, and head widths too narrow for a 128-byte swizzle row.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int THREADS = 256;    // ty = tid / 16 owns rows 4ty..4ty+3
constexpr float NEG = -1e30f;   // _NEG of flash_attention.py:23

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float4 ld_s4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st_s4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// Output column of a thread's c-th accumulator: D >= 64 takes float4 groups
// (4tx + 64g .. +3) so the V reads are 16 bytes a thread; narrower heads take
// one column every 16.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
    if constexpr (D >= 64) return 4 * tx + 64 * (c >> 2) + (c & 3);
    else return tx + 16 * c;
}

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)BQ * (D + 4) + (size_t)BK * (D + 4) +
                            (size_t)BK * D + (size_t)BQ * (BK + 4));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int hk,
             int sq, int sk, int kv_len, int causal, float scale) {
    static_assert(D % 16 == 0 && D <= 128, "head width");
    constexpr int QS = D + 4;           // Q and K tile row stride (floats)
    constexpr int PS = BK + 4;          // P tile row stride
    constexpr int NC = D / 16;          // output columns per thread
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);   // (BQ, QS), scaled f32
    float* Ks = Qs + BQ * QS;                      // (BK, QS)
    float* Vs = Ks + BK * QS;                      // (BK, D)
    float* Ps = Vs + BK * D;                       // (BQ, PS)

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int qt = gridDim.x - 1 - blockIdx.x;     // most kv tiles first
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = qt * BQ;
    const long long q_base = ((long long)(b * hq + h) * sq + q0) * D;
    const long long kv_base =
        (long long)(b * hk + h / (hq / hk)) * sk * D;

    for (int e = tid * 4; e < BQ * D; e += THREADS * 4) {
        const int r = e / D, c = e - r * D;
        float4 x = load4(q + q_base + e);
        x.x = __fmul_rn(x.x, scale);
        x.y = __fmul_rn(x.y, scale);
        x.z = __fmul_rn(x.z, scale);
        x.w = __fmul_rn(x.w, scale);
        st_s4(Qs + r * QS + c, x);
    }

    float m[4], l[4], acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    int n_kt = sk / BK;
    if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
    const bool masked = causal || kv_len < sk;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                // the last tile's readers are done
        const long long t_base = kv_base + (long long)k0 * D;
        for (int e = tid * 4; e < BK * D; e += THREADS * 4) {
            const int r = e / D, c = e - r * D;
            st_s4(Ks + r * QS + c, load4(k + t_base + e));
            st_s4(Vs + r * D + c, load4(v + t_base + e));
        }
        __syncthreads();

        // scores of rows 4ty + i against keys tx + 16j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qa[4], kb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = ld_s4(Qs + (4 * ty + i) * QS + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) kb[j] = ld_s4(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float t = s[i][j];
                    t = fmaf(qa[i].x, kb[j].x, t);
                    t = fmaf(qa[i].y, kb[j].y, t);
                    t = fmaf(qa[i].z, kb[j].z, t);
                    t = fmaf(qa[i].w, kb[j].w, t);
                    s[i][j] = t;
                }
        }
        if (masked) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int qpos = q0 + 4 * ty + i, kpos = k0 + tx + 16 * j;
                    const bool ok = (!causal || qpos >= kpos) && kpos < kv_len;
                    if (!ok) s[i][j] = NEG;
                }
        }

        // online softmax: a row's 64 scores lie on the 16 lanes of one
        // half-warp, so the row max and sum reduce with xor shuffles
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                Ps[(4 * ty + i) * PS + tx + 16 * j] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = alpha * l[i] + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();                // P complete

        // acc += P V over the tile's keys
#pragma unroll 2
        for (int kk = 0; kk < BK; kk += 4) {
            float4 pa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[i] = ld_s4(Ps + (4 * ty + i) * PS + kk);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float* vr = Vs + (kk + u) * D;
                float vv[NC];
                if constexpr (D >= 64) {
#pragma unroll
                    for (int g = 0; g < D / 64; ++g) {
                        const float4 w = ld_s4(vr + 4 * tx + 64 * g);
                        vv[4 * g] = w.x;
                        vv[4 * g + 1] = w.y;
                        vv[4 * g + 2] = w.z;
                        vv[4 * g + 3] = w.w;
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < NC; ++c) vv[c] = vr[tx + 16 * c];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                                  : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
                    for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float den = fmaxf(l[i], 1e-30f);
        T* orow = o + q_base + (long long)(4 * ty + i) * D;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            store1(orow + out_col<D>(tx, c), __fdiv_rn(acc[i][c], den));
    }
}

// ------------------------------------------------------------ Hopper body
namespace tc {

constexpr int BQ = 128;            // q rows per block: two warpgroups of 64
constexpr int BK = 128;            // keys per kv tile
constexpr int THREADS = 384;       // warpgroups 0-1 consume, 2 produces
constexpr int BOX_COLS = 64;       // a TMA box: 64 bf16 = one 128-byte row
constexpr int BOX_BYTES = 128 * 128;  // 128 rows of 128 bytes
constexpr int CONSUMER_WARPS = 8;
constexpr uint32_t CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// Shared memory of one block, from a 1024-byte aligned base: the Q tile, two
// K and two V stages (each tile D / 64 boxes of 128 rows x 128 bytes), then
// the barriers: Q full, K full x2, V full x2, stage empty x2.
template <int D>
struct Smem {
    static constexpr int TILE = 128 * D * 2;
    static constexpr int Q = 0, K = TILE, V = 3 * TILE, BAR = 5 * TILE;
    static constexpr int BYTES = BAR + 7 * 8 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// one box (64 columns x 128 rows) at (col, row) of a 2-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(row) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving register reads or writes across a wgmma
// wait (the hardware reads and writes them asynchronously)
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

#define ACC8(i)                                                              \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
        "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS32                                                               \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
    "%28, %29, %30, %31}"
#define REGS64                                                               \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) = A (64 x 16) B (16 x 128) [+ d]; A and B bf16 in shared
// memory, both K-major
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC64
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 fragment in registers) B (16 x N), B
// bf16 in shared memory, MN-major (the transpose bit)
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
        "}\n"
        : ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : ACC32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8
#undef ACC32
#undef ACC64
#undef REGS32
#undef REGS64

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of wgmma m64nN (per thread of a warpgroup: warp w,
// lane l): element r sits at row 16 w + l / 4 + 8 ((r / 2) % 2) and column
// 8 (r / 4) + 2 (l % 4) + r % 2.  Elements 8 j .. 8 j + 7 of an S
// accumulator are therefore the A fragment of k step j of P V.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(__grid_constant__ const CUtensorMap tq,
                __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int hq, int hk, int sq,
                int sk, int kv_len, int causal, float scale2) {
    using L = Smem<D>;
    constexpr int NB = D / BOX_COLS;    // boxes per tile
    constexpr int KS = D / 16;          // k steps of Q K^T
    constexpr int KV = BK / 16;         // k steps of P V
    constexpr int NO = D / 2;           // output accumulators per thread
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    uint8_t* const smem = smem_raw + (base - raw);
    const uint32_t sq_s = base + L::Q;
    const uint32_t bar = base + L::BAR;
    const uint32_t q_full = bar;
    auto k_full = [&](int st) { return bar + 8u * (1 + st); };
    auto v_full = [&](int st) { return bar + 8u * (3 + st); };
    auto empty = [&](int st) { return bar + 8u * (5 + st); };
    auto k_s = [&](int st) { return base + L::K + st * L::TILE; };
    auto v_s = [&](int st) { return base + L::V + st * L::TILE; };

    const int h = blockIdx.x, b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // most kv tiles first
    int n_kt = (kv_len + BK - 1) / BK;
    if (causal) n_kt = min(n_kt, q0 / BK + 1);

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int st = 0; st < 2; ++st) {
            mbar_init(k_full(st), 1);
            mbar_init(v_full(st), 1);
            mbar_init(empty(st), CONSUMER_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {
        // producer: one thread issues every load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == 256) {
            const int q_row = (b * hq + h) * sq + q0;
            const int k_row = (b * hk + h / (hq / hk)) * sk;
            mbar_expect_tx(q_full, BQ * D * 2);
#pragma unroll
            for (int c = 0; c < NB; ++c)
                tma_load(sq_s + c * BOX_BYTES, &tq, q_full, c * BOX_COLS, q_row);
            for (int it = 0; it < n_kt; ++it) {
                const int st = it & 1;
                if (it >= 2) mbar_wait(empty(st), ((it >> 1) - 1) & 1);
                mbar_expect_tx(k_full(st), BK * D * 2);
#pragma unroll
                for (int c = 0; c < NB; ++c)
                    tma_load(k_s(st) + c * BOX_BYTES, &tk, k_full(st),
                             c * BOX_COLS, k_row + it * BK);
                mbar_expect_tx(v_full(st), BK * D * 2);
#pragma unroll
                for (int c = 0; c < NB; ++c)
                    tma_load(v_s(st) + c * BOX_BYTES, &tv, v_full(st),
                             c * BOX_COLS, k_row + it * BK);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int t = threadIdx.x & 127, lane = t & 31;
        const int ra = 64 * wg + 16 * (t >> 5) + (lane >> 2);  // rows ra, ra + 8
        const int qa = q0 + ra, qb = qa + 8;
        const int cq = 2 * (lane & 3);
        // this warpgroup's 64 rows of each Q box
        const uint32_t q_rows = sq_s + wg * 64 * 128;

        float acc[NO], s[64];
#pragma unroll
        for (int r = 0; r < NO; ++r) acc[r] = 0.f;
#pragma unroll
        for (int r = 0; r < 64; ++r) s[r] = 0.f;
        float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
        uint32_t ph[KV][4], pl[KV][4];

        mbar_wait(q_full, 0);
        for (int it = 0; it < n_kt; ++it) {
            const int st = it & 1;
            const uint32_t par = (it >> 1) & 1;
            const int k0 = it * BK;

            // S = Q K^T
            mbar_wait(k_full(st), par);
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                const uint32_t off = (ks >> 2) * BOX_BYTES + (ks & 3) * 32;
                mma_ss_n128(s, desc_sw128(q_rows + off, 16, 1024),
                            desc_sw128(k_s(st) + off, 16, 1024), ks > 0);
            }
            wg_commit();
            wg_wait0();
            pin(s);

#pragma unroll
            for (int r = 0; r < 64; ++r) s[r] = __fmul_rn(s[r], scale2);
            if ((causal && k0 + BK - 1 > q0) || k0 + BK > kv_len) {
#pragma unroll
                for (int r = 0; r < 64; ++r) {
                    const int kpos = k0 + 8 * (r >> 2) + cq + (r & 1);
                    const int qpos = (r & 2) ? qb : qa;
                    if ((causal && qpos < kpos) || kpos >= kv_len) s[r] = NEG;
                }
            }

            // online softmax in base 2 on the fragment; a row lies on a quad
            float mx_a = NEG, mx_b = NEG;
#pragma unroll
            for (int r = 0; r < 64; ++r) {
                if (r & 2) mx_b = fmaxf(mx_b, s[r]);
                else mx_a = fmaxf(mx_a, s[r]);
            }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
                mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
            }
            const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
            const float al_a = ex2(__fsub_rn(m_a, mn_a));
            const float al_b = ex2(__fsub_rn(m_b, mn_b));
            m_a = mn_a;
            m_b = mn_b;
            float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
            for (int r = 0; r < 64; ++r) {
                const float p = ex2(__fsub_rn(s[r], (r & 2) ? mn_b : mn_a));
                s[r] = p;
                if (r & 2) sum_b = __fadd_rn(sum_b, p);
                else sum_a = __fadd_rn(sum_a, p);
            }
            l_a = __fadd_rn(__fmul_rn(al_a, l_a), sum_a);   // this lane's part
            l_b = __fadd_rn(__fmul_rn(al_b, l_b), sum_b);

            // P = P_hi + P_lo, each a bf16 A fragment
#pragma unroll
            for (int j = 0; j < KV; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float x0 = s[8 * j + 2 * e], x1 = s[8 * j + 2 * e + 1];
                    const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
                    const float2 hf = __bfloat1622float2(hi);
                    ph[j][e] = bits(hi);
                    pl[j][e] = bits(__floats2bfloat162_rn(__fsub_rn(x0, hf.x),
                                                          __fsub_rn(x1, hf.y)));
                }
#pragma unroll
            for (int r = 0; r < NO; ++r)
                acc[r] = __fmul_rn(acc[r], (r & 2) ? al_b : al_a);

            // O += P_hi V + P_lo V
            mbar_wait(v_full(st), par);
            wg_fence();
#pragma unroll
            for (int j = 0; j < KV; ++j) {
                const uint64_t dv = desc_sw128(v_s(st) + j * 16 * 128,
                                               BOX_BYTES, 1024);
                mma_rs(acc, ph[j], dv);
                mma_rs(acc, pl[j], dv);
            }
            wg_commit();
            wg_wait0();
            pin(acc);
            pin(ph);
            pin(pl);
            if (lane == 0) mbar_arrive(empty(st));
        }

        // epilogue: the quad's sums of l, divide, round, stage, store
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            l_a = __fadd_rn(l_a, __shfl_xor_sync(0xffffffffu, l_a, off));
            l_b = __fadd_rn(l_b, __shfl_xor_sync(0xffffffffu, l_b, off));
        }
        const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        uint8_t* const q_gen = smem + L::Q;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int hb = 0; hb < 2; ++hb) {
                const int r = 4 * j + 2 * hb, row = ra + 8 * hb;
                const float den = hb ? den_b : den_a;
                const __nv_bfloat162 v = __floats2bfloat162_rn(
                    __fdiv_rn(acc[r], den), __fdiv_rn(acc[r + 1], den));
                const int off = (j >> 3) * BOX_BYTES + row * 128 +
                                (((j & 7) ^ (row & 7)) << 4) + cq * 2;
                *reinterpret_cast<__nv_bfloat162*>(q_gen + off) = v;
            }
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
        constexpr int CH = D / 8;                       // 16-byte chunks a row
        __nv_bfloat16* const o_rows =
            o + ((long long)(b * hq + h) * sq + q0) * D;
#pragma unroll
        for (int i = t; i < 64 * CH; i += 128) {
            const int row = 64 * wg + i / CH, c = i % CH;
            const int off = (c >> 3) * BOX_BYTES + row * 128 +
                            (((c & 7) ^ (row & 7)) << 4);
            *reinterpret_cast<uint4*>(o_rows + (long long)row * D + c * 8) =
                *reinterpret_cast<const uint4*>(q_gen + off);
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda of its own
EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// a (rows, D) bf16 row-major matrix, boxes of 64 columns x 128 rows
bool tensor_map(CUtensorMap* map, const void* ptr, long long rows, int d) {
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
    const cuuint32_t box[2] = {BOX_COLS, 128};
    const cuuint32_t estride[2] = {1, 1};
    return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          const_cast<void*>(ptr), dims, strides, box, estride,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hk, int sq, int sk, int kv_len, int causal,
           void* stream) {
    if (sq % BQ != 0 || sk % BK != 0 ||
        ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
        return (int)cudaErrorInvalidValue;
    if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
    CUtensorMap mq, mk, mv;
    if (!tensor_map(&mq, q, (long long)b * hq * sq, D) ||
        !tensor_map(&mk, k, (long long)b * hk * sk, D) ||
        !tensor_map(&mv, v, (long long)b * hk * sk, D))
        return (int)cudaErrorInvalidValue;
    const int smem = Smem<D>::BYTES;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    // log2(e) / sqrt(D) rounded once to f32
    const float scale2 = (float)(1.4426950408889634 / sqrt((double)D));
    const dim3 grid((unsigned)hq, (unsigned)b, (unsigned)(sq / BQ));
    flash_tc_kernel<D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        mq, mk, mv, (__nv_bfloat16*)o, hq, hk, sq, sk, kv_len, causal, scale2);
    return (int)cudaGetLastError();
}

}  // namespace tc

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b,
             int hq, int hk, int sq, int sk, int kv_len, int causal,
             void* stream) {
    const size_t smem = smem_bytes<D>();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // 1/sqrt(D) rounded once to f32, as the reference's Python scalar is
    const float scale = (float)(1.0 / sqrt((double)D));
    const dim3 grid((unsigned)(sq / BQ), (unsigned)hq, (unsigned)b);
    flash_kernel<T, D><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hk, sq, sk, kv_len,
        causal, scale);
    return (int)cudaGetLastError();
}

// bf16 with D 64 or 128 goes to the tensor cores (the 128-byte swizzle
// row is 64 bf16); every other case to the CUDA cores
constexpr bool tensor_core_body(bool bf16, int d) { return bf16 && d >= 64; }

template <typename T, int D>
int launch_body(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hk, int sq, int sk, int kv_len, int causal,
                void* stream) {
    if constexpr (tensor_core_body(std::is_same_v<T, __nv_bfloat16>, D))
        return tc::launch<D>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal,
                             stream);
    else
        return launch_d<T, D>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal,
                              stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hk, int sq, int sk, int d, int kv_len, int causal,
           void* stream) {
    if (b <= 0 || hq <= 0 || sq <= 0) return 0;
    if (hk <= 0 || hq % hk != 0 || sq % BQ != 0 || sk <= 0 || sk % BK != 0 ||
        kv_len <= 0 || kv_len > sk)
        return (int)cudaErrorInvalidValue;
    switch (d) {
        case 16: return launch_body<T, 16>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        case 32: return launch_body<T, 32>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        case 64: return launch_body<T, 64>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        case 128: return launch_body<T, 128>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q (b, hq, sq, d), k and v (b, hk, sk, d), out (b, hq, sq, d), contiguous,
// all of one type; sq and sk multiples of 64 (128 for the tensor-core body;
// the wrapper pads to 128); d in {16, 32, 64, 128}; keys at kv_len and
// beyond are masked (kv_len = sk masks none).  Each returns the CUDA error
// code of the launch (0 on success; cudaErrorInvalidValue for shapes it does
// not take).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int b, int hq, int hk, int sq,
                                   int sk, int d, int kv_len, int causal,
                                   void* stream) {
    return launch<float>(q, k, v, o, b, hq, hk, sq, sk, d, kv_len, causal,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int hq,
                                    int hk, int sq, int sk, int d, int kv_len,
                                    int causal, void* stream) {
    return launch<__nv_bfloat16>(q, k, v, o, b, hq, hk, sq, sk, d, kv_len,
                                 causal, stream);
}

// The body a launch of this type (bf16 nonzero) and head width takes: 1 the
// tensor cores, 0 the CUDA cores, -1 none (the launch is refused).
extern "C" int flash_attention_body(int bf16, int d) {
    if (d != 16 && d != 32 && d != 64 && d != 128) return -1;
    return tensor_core_body(bf16 != 0, d) ? 1 : 0;
}
