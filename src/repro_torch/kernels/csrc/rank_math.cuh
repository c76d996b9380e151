// Clenshaw rank evaluation + ring id for one value of one (cluster, pivot)
// group: the device twin of repro/kernels/rankeval.py::rank_math.  rankeval
// and pdist_rankeval both call this one function, so the staged and fused
// plans agree bit for bit (the snapshot's error bound E is certified on the
// staged kernel).
//
//   t    = clip(((x - lo) / max(hi - lo, 1e-30)) * 2 - 1, -1, 1)
//   b1, b2 = 0;  for k = C-1 .. 1:  b1, b2 = (c_k + (2t)*b1) - b2, b1
//   r    = (c_0 + t*b1) - b2
//   rank = clip(rint(r), 0, max(n - 1, 0))            (rint: half to even)
//   rid  = clip(floor(rank / max(ceil(n / N), 1)), 0, N - 1)
//
// Every step is an f32 operation rounded to nearest: no FMA contraction,
// IEEE division.
#pragma once

__device__ __forceinline__ float clip_f(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ void rank_math(float x, const float* coef,
                                          int n_coef, float lo, float hi,
                                          float n, int n_rings,
                                          int* rank_out, int* rid_out) {
    const float den = fmaxf(__fsub_rn(hi, lo), 1e-30f);
    float t = __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(x, lo), den), 2.f), 1.f);
    t = clip_f(t, -1.f, 1.f);
    const float t2 = __fmul_rn(2.f, t);
    float b1 = 0.f, b2 = 0.f;
    for (int k = n_coef - 1; k >= 1; --k) {
        const float nb = __fsub_rn(__fadd_rn(coef[k], __fmul_rn(t2, b1)), b2);
        b2 = b1;
        b1 = nb;
    }
    const float r = __fsub_rn(__fadd_rn(coef[0], __fmul_rn(t, b1)), b2);
    const float rank = clip_f(rintf(r), 0.f, fmaxf(__fsub_rn(n, 1.f), 0.f));
    const float width = ceilf(__fdiv_rn(n, (float)n_rings));
    const float rid = clip_f(floorf(__fdiv_rn(rank, fmaxf(width, 1.f))), 0.f,
                             (float)(n_rings - 1));
    *rank_out = (int)rank;
    *rid_out = (int)rid;
}
