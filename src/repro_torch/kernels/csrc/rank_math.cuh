// Clenshaw rank evaluation + ring id for values of one (cluster, pivot)
// group: the device twin of repro/kernels/rankeval.py::rank_math.  rankeval
// and pdist_rankeval both call this one function, with the group's constants
// from rank_group, so the staged and fused plans agree bit for bit (the
// snapshot's error bound E is certified on the staged kernel).
//
// Per group, once (rank_group):
//   den = max(hi - lo, 1e-30),  nmax = max(n - 1, 0),
//   width = max(ceil(n / N), 1)
// Per value (rank_math):
//   t    = clip(((x - lo) / den) * 2 - 1, -1, 1)
//   b1, b2 = 0;  for k = C-1 .. 1:  b1, b2 = (c_k + (2t)*b1) - b2, b1
//   r    = (c_0 + t*b1) - b2
//   rank = clip(rint(r), 0, nmax)                     (rint: half to even)
//   rid  = clip(floor(rank / width), 0, N - 1)
// Every step is an f32 operation rounded to nearest: no FMA contraction,
// IEEE division.  The constants are the same operations on the same operands
// as when every value computed them, so hoisting them changes no bit.
//
// NaN: every max and min keeps a NaN (PTX max.NaN / min.NaN), as jnp.clip,
// jnp.maximum and torch.clamp do; fminf/fmaxf would drop it, and a NaN x
// would take the model's rank at lo.  So a NaN x gives a NaN rank and rid,
// and the conversions to int32 are cvt.rzi.s32.f32, which turns NaN into 0
// (PTX ISA, cvt: NaN converts to 0 for an integer destination), as XLA's
// float-to-int conversion does: rank 0 and ring 0, the reference's answer.
// Where no operand is NaN, max.NaN and min.NaN give fmaxf's and fminf's
// value, up to the sign of a zero, which changes no output (an exact zero
// adds nothing to a sum whatever its sign, and rank and rid are integers).
#pragma once

struct __align__(16) RankGroup {
    float lo, den, nmax, width;
};

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// clip(v, lo, hi) = min(max(v, lo), hi), keeping a NaN v.
__device__ __forceinline__ float clip_nan(float v, float lo, float hi) {
    return min_nan(max_nan(v, lo), hi);
}

__device__ __forceinline__ RankGroup rank_group(float lo, float hi, float n,
                                                int n_rings) {
    RankGroup gr;
    gr.lo = lo;
    gr.den = max_nan(__fsub_rn(hi, lo), 1e-30f);
    gr.nmax = max_nan(__fsub_rn(n, 1.f), 0.f);
    gr.width = max_nan(ceilf(__fdiv_rn(n, (float)n_rings)), 1.f);
    return gr;
}

// rank and rid of V values x of one group, the steps of the V values
// interleaved.  C > 0: C coefficients (c may be a register array, indexed
// at compile time once unrolled); C == 0: n_coef of them, read from c.
template <int C, int V>
__device__ __forceinline__ void rank_math(const float (&x)[V], const float* c,
                                          int n_coef, const RankGroup& gr,
                                          int n_rings, int (&rank)[V],
                                          int (&rid)[V]) {
    float t[V], t2[V], b1[V], b2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const float u = __fdiv_rn(__fsub_rn(x[i], gr.lo), gr.den);
        t[i] = clip_nan(__fsub_rn(__fmul_rn(u, 2.f), 1.f), -1.f, 1.f);
        t2[i] = __fmul_rn(2.f, t[i]);
        b1[i] = 0.f;
        b2[i] = 0.f;
    }
    const int nc = C > 0 ? C : n_coef;
#pragma unroll
    for (int k = nc - 1; k >= 1; --k) {
        const float ck = c[k];
#pragma unroll
        for (int i = 0; i < V; ++i) {
            const float nb =
                __fsub_rn(__fadd_rn(ck, __fmul_rn(t2[i], b1[i])), b2[i]);
            b2[i] = b1[i];
            b1[i] = nb;
        }
    }
    const float rid_max = (float)(n_rings - 1);
#pragma unroll
    for (int i = 0; i < V; ++i) {
        const float r = __fsub_rn(__fadd_rn(c[0], __fmul_rn(t[i], b1[i])),
                                  b2[i]);
        const float rk = clip_nan(rintf(r), 0.f, gr.nmax);
        const float rd =
            clip_nan(floorf(__fdiv_rn(rk, gr.width)), 0.f, rid_max);
        rank[i] = __float2int_rz(rk);
        rid[i] = __float2int_rz(rd);
    }
}
