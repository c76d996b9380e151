// Squared-L2 distance by the Gram trick, shared by pdist, range_filter and
// pdist_rankeval so the three kernels compute every (query, point) pair with
// one f32 operation sequence.
//
// Order (repeated by the plain PyTorch versions in ../pdist.py):
//   qn = sum_k q[k]*q[k],  pn = sum_k p[k]*p[k],  g = sum_k q[k]*p[k]
//   (each summed from k = 0 upwards, every product and sum rounded on its own)
//   d2 = (qn + pn) - 2*g,  clamped at 0 as `v < 0 ? 0 : v`
// The clamp keeps a NaN (fmaxf would turn it into 0 and count a padded slot
// as a hit).  The intrinsics round each step to nearest and forbid FMA
// contraction, so the result does not depend on -fmad or on the caller.
#pragma once

__device__ __forceinline__ float sq_norm(const float* x, int stride, int d) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
        const float v = x[(long long)k * stride];
        s = __fadd_rn(s, __fmul_rn(v, v));
    }
    return s;
}

__device__ __forceinline__ float gram_sq(float qn, float pn,
                                         const float* q, int q_stride,
                                         const float* p, int p_stride, int d) {
    float g = 0.f;
    for (int k = 0; k < d; ++k)
        g = __fadd_rn(g, __fmul_rn(q[(long long)k * q_stride],
                                   p[(long long)k * p_stride]));
    const float v = __fsub_rn(__fadd_rn(qn, pn), __fmul_rn(2.f, g));
    return v < 0.f ? 0.f : v;
}
