// flash_attention: GQA online-softmax attention, causal or not, f32 math.
//   q (B, Hq, Sq, D), k and v (B, Hk, Sk, D), Hq % Hk == 0, f32 or bf16;
//   out (B, Hq, Sq, D) in q's type.  q head h reads kv head h / (Hq / Hk):
//   K and V are never repeated in memory.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (:74), body _flash_kernel (:26).  That kernel walks
// a (b, h, q block, kv block) grid in order and carries m, l and the output
// block from one kv step to the next in VMEM.  Blocks on the H100 run in no
// order, so here one thread block owns a (b, h, 64-row q tile) and walks its
// kv tiles in a loop, keeping the running m, l and output in registers.
//
// Math, as _flash_kernel: q is cast to f32 and multiplied by 1/sqrt(D) in
// f32; scores are f32; a masked score is -1e30 (not -inf, so exp(s - m)
// stays finite); per kv tile m_new = max(m, max_j s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = alpha * l + sum(p), acc = acc * alpha + p.V;
// at the end out = acc / max(l, 1e-30).  The causal mask is qpos >= kpos,
// both counted from 0 at the top left (flash_attention.py:50-52); keys at or
// beyond kv_len are masked; kv tiles wholly above the diagonal are skipped
// (:40), which changes nothing, since such a tile would give p = 0 and
// alpha = 1 exactly.  Dot products are explicit f32 fused multiply-adds
// (the flags forbid contraction everywhere else); exp is expf, not __expf.
// The plain PyTorch version (../ref.py flash_attention_ref) runs the same
// recurrence over 128-wide kv blocks, so the two differ by rounding only.
//
// What bounds it on an H100: operations.  At a Llama-3-8B prefill (B 4,
// Hq 32, Hk 8, S 2048, D 128, causal) the function needs 4 D flops for each
// of the 2.1M live (q, k) pairs of each of the 128 (b, h) pairs, 137 GFLOP,
// against 168 MB in and out (bf16); at the f32 rate outside the tensor cores
// that is about 2 ms of arithmetic and 0.05 ms of memory time.  This version
// does the arithmetic on the CUDA cores in f32: each thread owns 4 rows and
// a 4 x 4 score tile, read as float4s from shared-memory tiles whose rows
// are padded by 4 floats so a warp's float4 reads hit distinct banks.  The
// tensor cores (wgmma, bf16 operands), TMA and a pipelined K/V ring are
// later work.  Blocks start at the last q tile, which has the most live kv
// tiles, so the causal tail of the grid is short.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hk, int sq, int sk, int d, int kv_len, int causal,
           void* stream) {
    if (b <= 0 || hq <= 0 || sq <= 0) return 0;
    if (hk <= 0 || hq % hk != 0 || sq % BQ != 0 || sk <= 0 || sk % BK != 0 ||
        kv_len <= 0 || kv_len > sk)
        return (int)cudaErrorInvalidValue;
    switch (d) {
        case 16: return launch_d<T, 16>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        case 32: return launch_d<T, 32>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        case 64: return launch_d<T, 64>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        case 128: return launch_d<T, 128>(q, k, v, o, b, hq, hk, sq, sk, kv_len, causal, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q (b, hq, sq, d), k and v (b, hk, sk, d), out (b, hq, sq, d), contiguous,
// all of one type; sq and sk multiples of 64 (the wrapper pads to 128);
// d in {16, 32, 64, 128}; keys at kv_len and beyond are masked (kv_len = sk
// masks none).  Each returns the CUDA error code of the launch (0 on
// success; cudaErrorInvalidValue for shapes it does not take).
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
