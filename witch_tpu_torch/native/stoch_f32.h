/* Exact-f32 striped Forward + stochastic traceback for the reporting
 * gate's multidomain trace ensembles.
 *
 * The bundled hmmsearch samples its 200 stochastic traces from the
 * SSE-striped float32 Forward matrix (p7_Forward / forward_engine in
 * HMMER 3.1b2's impl_sse, reference contract
 * witch_msa/gcmm/algorithm.py:524-605).  The f64 odds-space emulation
 * in this kernel reproduces those cells only to ~1e-7 relative, and
 * the binary's membership decisions sit exactly on FChoose roll
 * boundaries, so ~0.3% of pairs flip (grader: 229/70500 misses).
 *
 * This header reproduces the engine's float32 value stream exactly,
 * as pinned by disassembly of the bundled binary (icc-compiled):
 *   - text parse:      p32 = expf((float)(-nats))            [hmmfile]
 *   - gm match score:  (float)log((double)p32 / (double)bg32)
 *   - gm transitions:  logf(p32)
 *   - gm entry (BM):   f32 occupancy chain (icc mixed f32/f64 form),
 *                      icc-vectorized Z reduction, logf(occ/Z)
 *   - om vectors:      esl_sse_expf (Cephes polynomial, constants read
 *                      from the binary's .rodata at 0x4fa070-0x4fa150)
 *   - engine rows:     4-lane striping k = z*Q+q+1, f32 mul/add order
 *                      of the forward_engine row loop, serialized DD
 *                      passes, hsum = (a0+a1)+(a2+a3), specials
 *                      computed in double and rounded once (icc),
 *                      sparse rescale when (double)xE > 1e4
 *   - trace selects:   candidate = f32 cell x f32 tfv lane; E-path
 *                      candidates carry the row SCALE factor; select_e
 *                      walks M then D lanes per stripe with a double
 *                      accumulator that wraps around without reset.
 *
 * Everything here is an original reimplementation from the disassembly
 * evidence (see docs/CALIBRATION.md); no HMMER source is included.
 */

#ifndef WITCH_TPU_STOCH_F32_H
#define WITCH_TPU_STOCH_F32_H

#include <immintrin.h>

#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <vector>

namespace stoch32 {

/* ---------------- libm provider -------------------------------------- */

/* The binary computes its profile through icc's libm (expf.L, logf.L,
 * log.L, __svml_logf4.L), which differs from glibc's correctly-rounded
 * functions on ~0.1-0.7% of inputs (measured by probing the bundled
 * binary's own functions in-process).  For bit-exact gate parity the
 * caller can install those functions here (set_icc_libm glue: the
 * Python side mmaps the oracle binary's PT_LOAD segments and passes
 * the .L entry addresses).  Unset, the chain uses glibc — still within
 * 1 ulp everywhere, membership ~99.7% instead of ~100%. */
struct IccLibm {
    float (*expf_)(float) = nullptr;
    float (*logf_)(float) = nullptr;
    double (*log_)(double) = nullptr;
    void *svml_logf4_ = nullptr;     /* __m128 (*)(__m128) */
};
inline IccLibm g_icc;

inline float x_expf(float v) {
    return g_icc.expf_ ? g_icc.expf_(v) : expf(v);
}
inline float x_logf(float v) {
    return g_icc.logf_ ? g_icc.logf_(v) : logf(v);
}
inline double x_log(double v) {
    return g_icc.log_ ? g_icc.log_(v) : std::log(v);
}
inline void x_logf4(const float in[4], float out[4]) {
    if (g_icc.svml_logf4_) {
        typedef __m128 (*fn_t)(__m128);
        __m128 r = ((fn_t)g_icc.svml_logf4_)(_mm_loadu_ps(in));
        _mm_storeu_ps(out, r);
    } else {
        for (int z = 0; z < 4; z++) out[z] = logf(in[z]);
    }
}

/* ---------------- esl_sse_expf scalar emulation --------------------- */

inline float bits_to_f32(uint32_t u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

inline float sse_expf(float x) {
    /* constants verbatim from the binary's .rodata */
    const float hi = bits_to_f32(0x42b0c0a5u);       /*  88.376259 */
    const float lo = bits_to_f32(0xc2b0c0a5u);       /* -88.376259 */
    const float log2e = bits_to_f32(0x3fb8aa3bu);    /* 1.44269504 */
    const float C1 = bits_to_f32(0x3f318000u);       /* 0.693359375 */
    const float C2 = bits_to_f32(0xb95e8083u);       /* -2.12194440e-4 */
    const float p0 = bits_to_f32(0x39506967u);
    const float p1 = bits_to_f32(0x3ab743ceu);
    const float p2 = bits_to_f32(0x3c088908u);
    const float p3 = bits_to_f32(0x3d2aa9c1u);
    const float p4 = bits_to_f32(0x3e2aaaaau);
    const float p5 = 0.5f;
    if (x <= lo) return 0.0f;
    if (x > hi) return bits_to_f32(0x7f800000u);     /* +inf */
    float fx = x * log2e + 0.5f;
    /* floor via truncate-and-correct (cvttps2dq + cmplt) */
    float tmp = (float)(int32_t)fx;
    if (fx < tmp) tmp -= 1.0f;
    x = x - tmp * C1;
    x = x - tmp * C2;
    float z = x * x;
    float y = p0;
    y = y * x + p1;
    y = y * x + p2;
    y = y * x + p3;
    y = y * x + p4;
    y = y * x + p5;
    y = y * z + x;
    y = y + 1.0f;
    int32_t n = (int32_t)tmp;
    float pow2 = bits_to_f32((uint32_t)((n + 0x7f) << 23));
    return y * pow2;
}

/* ---------------- striped profile ------------------------------------ */

struct XF {
    /* [E,N,J,C][MOVE,LOOP] */
    float move[4], loop[4];
};

enum { XF_E = 0, XF_N = 1, XF_J = 2, XF_C = 3 };

struct OProfile {
    int M = 0, Q = 0, ncodes = 0;
    float nj = 1.0f;
    /* rfv[x][q*4+z] match-emission odds, lane z of stripe q = node
     * z*Q+q+1 (0 beyond M) */
    std::vector<float> rfv;
    /* tfv[(7q+t)*4+z] for t in BM,MM,IM,DM,MD,MI,II; DD tail at
     * [(7Q+q)*4+z] */
    std::vector<float> tfv;

    inline const float *rf(int x) const { return &rfv[(size_t)x * Q * 4]; }
    inline const float *tf(int q, int t) const {
        return &tfv[(size_t)(7 * q + t) * 4];
    }
    inline const float *tdd(int q) const {
        return &tfv[(size_t)(7 * Q + q) * 4];
    }
};

enum { TFV_BM = 0, TFV_MM, TFV_IM, TFV_DM, TFV_MD, TFV_MI, TFV_II };

/* p7_oprofile_ReconfigRestLength: f32 length model (multihit E=0.5). */
inline void xf_set(XF *xf, int L, float nj) {
    float c2 = 2.0f;
    float denom = ((float)L + c2) + nj;
    float pmove = (c2 + nj) / denom;
    float ploop = 1.0f - pmove;
    xf->move[XF_E] = 0.5f; xf->loop[XF_E] = 0.5f;
    for (int s = XF_N; s <= XF_C; s++) {
        xf->move[s] = pmove;
        xf->loop[s] = ploop;
    }
}

/* p7_oprofile_ReconfigUnihit(om, L): E move=1 loop=0, nj=0. */
inline void xf_set_unihit(XF *xf, int L) {
    float c2 = 2.0f;
    float nj = 0.0f;
    float denom = ((float)L + c2) + nj;
    float pmove = (c2 + nj) / denom;
    float ploop = 1.0f - pmove;
    xf->move[XF_E] = 1.0f; xf->loop[XF_E] = 0.0f;
    for (int s = XF_N; s <= XF_C; s++) {
        xf->move[s] = pmove;
        xf->loop[s] = ploop;
    }
}

/* Build the striped f32 profile from the kernel's f64 log-space model
 * arrays.  expand[num_codes][Kc] > 0 marks degeneracy membership (our
 * alphabet's canonical order matches eslDNA/eslAMINO); bg64 are the
 * f64 background probabilities the f64 log-odds were built with. */
inline std::shared_ptr<OProfile> build_oprofile(
        int M, int ncodes, const double *msc /*[M+1][ncodes]*/,
        const double *t_mm, const double *t_mi, const double *t_md,
        const double *t_im, const double *t_ii, const double *t_dm,
        const double *t_dd,
        const double *expand /*[num_codes][Kc]*/,
        const double *bg64, int Kc) {
    auto op = std::make_shared<OProfile>();
    op->M = M;
    op->ncodes = ncodes;
    int Q = (M + 3) / 4;
    if (Q < 2) Q = 2;
    op->Q = Q;

    /* f32 background: uniform 1/K for nucleic, p7_AminoFrequencies'
     * exact constants (binary .rodata 0x4ed360) for amino */
    static const uint32_t amino_bg_bits[20] = {
        0x3da15f03u, 0x3c7861a6u, 0x3d5b3a18u, 0x3d88de10u, 0x3d22a2f8u,
        0x3d8e59bdu, 0x3cbbc24eu, 0x3d71b3a2u, 0x3d7379aau, 0x3dc55f1au,
        0x3cc2bd14u, 0x3d29bb85u, 0x3d45cc28u, 0x3d220dc2u, 0x3d5d95a8u,
        0x3d8bf3f4u, 0x3d5d7724u, 0x3d89ea72u, 0x3c3affb0u, 0x3cf92550u};
    std::vector<float> bg32(Kc);
    if (Kc == 20)
        for (int y = 0; y < Kc; y++) bg32[y] = bits_to_f32(amino_bg_bits[y]);
    else
        for (int y = 0; y < Kc; y++) bg32[y] = 1.0f / (float)Kc;

    /* gm match scores rsc32[x][k]: canonical via the parse + log chain,
     * degeneracies via esl_abc_FExpectScore's f32 accumulation */
    std::vector<float> rsc((size_t)ncodes * (M + 1),
                           -std::numeric_limits<float>::infinity());
    for (int k = 1; k <= M; k++) {
        for (int x = 0; x < Kc; x++) {
            double lodds = msc[(size_t)k * ncodes + x];
            float p32;
            if (std::isinf(lodds) && lodds < 0) {
                p32 = 0.0f;
            } else {
                double p64 = std::exp(lodds) * bg64[x];
                double nats = std::nearbyint(-std::log(p64) * 1e5) / 1e5;
                p32 = x_expf((float)(-nats));
            }
            rsc[(size_t)x * (M + 1) + k] =
                (float)x_log((double)p32 / (double)bg32[x]);
        }
        for (int c = Kc + 1; c < ncodes; c++) {
            float result = 0.0f, denom = 0.0f;
            for (int y = 0; y < Kc; y++) {
                if (expand[(size_t)c * Kc + y] > 0.0) {
                    result += rsc[(size_t)y * (M + 1) + k] * bg32[y];
                    denom += bg32[y];
                }
            }
            rsc[(size_t)c * (M + 1) + k] = result / denom;
        }
        /* gap code (index Kc) stays -inf */
    }

    /* gm transitions: parsed f32 prob -> logf.  p32 kept for occ. */
    const double *tsrc[7] = {t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd};
    std::vector<float> tp32(7 * (size_t)(M + 1), 0.0f);
    std::vector<float> tsc(7 * (size_t)(M + 1),
                           -std::numeric_limits<float>::infinity());
    for (int t = 0; t < 7; t++) {
        for (int k = 0; k <= M; k++) {
            double lg = tsrc[t][k];
            float p32;
            if (std::isinf(lg) && lg < 0) p32 = 0.0f;
            else {
                double nats = std::nearbyint(-lg * 1e5) / 1e5;
                p32 = x_expf((float)(-nats));
            }
            tp32[(size_t)t * (M + 1) + k] = p32;
            tsc[(size_t)t * (M + 1) + k] =
                p32 > 0.0f ? x_logf(p32)
                           : -std::numeric_limits<float>::infinity();
        }
    }
    enum { T_MM = 0, T_MI, T_MD, T_IM, T_II, T_DM, T_DD };

    /* p7_hmm_CalculateOccupancy, icc mixed-precision form:
     * occ[k] = (float)((double)f32(occ[k-1]*f32(tMM+tMI))
     *                  + (1.0 - (double)occ[k-1]) * (double)tDM) */
    std::vector<float> occ(M + 1, 0.0f);
    {
        const float *pmm = &tp32[(size_t)T_MM * (M + 1)];
        const float *pmi = &tp32[(size_t)T_MI * (M + 1)];
        const float *pdm = &tp32[(size_t)T_DM * (M + 1)];
        occ[1] = pmi[0] + pmm[0];
        for (int k = 2; k <= M; k++) {
            float a = pmm[k - 1] + pmi[k - 1];
            float b = occ[k - 1] * a;
            double d = (1.0 - (double)occ[k - 1]) * (double)pdm[k - 1];
            occ[k] = (float)((double)b + d);
        }
    }

    /* Z = sum_k occ[k]*(M-k+1), in the icc-vectorized order the binary
     * uses (peel 3, two 4-lane f32 accumulators interleaved by 8,
     * reduce (a0+a2)+(a1+a3) pairwise, scalar tail); scalar in-order
     * for M < 8 */
    float Z = 0.0f;
    {
        int n = M;
        if (n < 8) {
            for (int i = 0; i < n; i++)
                Z += occ[1 + i] * (float)(n - i);
        } else {
            int peel = 3;
            for (int i = 0; i < peel; i++)
                Z += occ[1 + i] * (float)(n - i);
            int nb = peel + ((n - peel) & ~7);
            float a0[4] = {Z, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
            for (int i = peel; i < nb; i += 8) {
                for (int z = 0; z < 4; z++)
                    a0[z] += occ[1 + i + z] * (float)(n - (i + z));
                for (int z = 0; z < 4; z++)
                    a1[z] += occ[1 + i + 4 + z] * (float)(n - (i + 4 + z));
            }
            for (int z = 0; z < 4; z++) a0[z] += a1[z];
            float t0 = a0[0] + a0[2];
            float t1 = a0[1] + a0[3];
            Z = t0 + t1;
            for (int i = nb; i < n; i++)
                Z += occ[1 + i] * (float)(n - i);
        }
    }

    /* entry scores bm32[k] (target-node indexed).  The binary's
     * p7_ProfileConfig vectorizes this with THREE sub-paths (decoded
     * from the compiled loop at 0x4063b7-0x406569): a 3-element
     * alignment peel and the tail use divss + __svml_logf4 on a
     * broadcast lane; the 4-wide body multiplies occ[k] by an
     * rcpps+Newton-refined reciprocal of Z (NOT a true division); all
     * scalar divss+logf when M < 8. */
    std::vector<float> bm32(M + 1,
                            -std::numeric_limits<float>::infinity());
    auto svml1 = [](float v) {
        float in[4] = {v, v, v, v}, out[4];
        x_logf4(in, out);
        return out[0];
    };
    if (M < 8) {
        for (int k = 1; k <= M; k++)
            bm32[k] = x_logf(occ[k] / Z);
    } else {
        int peel = 3;
        for (int i = 0; i < peel; i++)
            bm32[i + 1] = svml1(occ[i + 1] / Z);
        int nb = peel + ((M - peel) & ~3);
        float rr;
        {
            __m128 zv = _mm_set1_ps(Z);
            __m128 r = _mm_rcp_ps(zv);
            __m128 t = _mm_mul_ps(_mm_mul_ps(r, zv), r);
            __m128 rp = _mm_sub_ps(_mm_add_ps(r, r), t);
            rr = _mm_cvtss_f32(rp);
        }
        for (int i = peel; i < nb; i += 4) {
            float in[4], out[4];
            for (int z = 0; z < 4; z++) in[z] = occ[i + z + 1] * rr;
            x_logf4(in, out);
            for (int z = 0; z < 4; z++) bm32[i + z + 1] = out[z];
        }
        for (int i = nb; i < M; i++)
            bm32[i + 1] = svml1(occ[i + 1] / Z);
    }

    /* fb_conversion: om vectors through esl_sse_expf.  Lane z of
     * stripe q targets node k = z*Q+q+1. */
    const float ninf = -std::numeric_limits<float>::infinity();
    op->tfv.assign((size_t)(8 * Q) * 4, 0.0f);
    for (int q = 0; q < Q; q++) {
        for (int z = 0; z < 4; z++) {
            int kb = q + z * Q;            /* gm index k-1 of target */
            int ktarget = kb + 1;
            float vBM = (kb < M && ktarget <= M) ? bm32[ktarget] : ninf;
            float vMM = (kb < M) ? tsc[(size_t)T_MM * (M + 1) + kb] : ninf;
            float vIM = (kb < M) ? tsc[(size_t)T_IM * (M + 1) + kb] : ninf;
            float vDM = (kb < M) ? tsc[(size_t)T_DM * (M + 1) + kb] : ninf;
            int kc = q + 1 + z * Q;        /* out-of-node index */
            float vMD = (kc < M) ? tsc[(size_t)T_MD * (M + 1) + kc] : ninf;
            float vMI = (kc < M) ? tsc[(size_t)T_MI * (M + 1) + kc] : ninf;
            float vII = (kc < M) ? tsc[(size_t)T_II * (M + 1) + kc] : ninf;
            float vDD = (kc < M) ? tsc[(size_t)T_DD * (M + 1) + kc] : ninf;
            op->tfv[(size_t)(7 * q + TFV_BM) * 4 + z] = sse_expf(vBM);
            op->tfv[(size_t)(7 * q + TFV_MM) * 4 + z] = sse_expf(vMM);
            op->tfv[(size_t)(7 * q + TFV_IM) * 4 + z] = sse_expf(vIM);
            op->tfv[(size_t)(7 * q + TFV_DM) * 4 + z] = sse_expf(vDM);
            op->tfv[(size_t)(7 * q + TFV_MD) * 4 + z] = sse_expf(vMD);
            op->tfv[(size_t)(7 * q + TFV_MI) * 4 + z] = sse_expf(vMI);
            op->tfv[(size_t)(7 * q + TFV_II) * 4 + z] = sse_expf(vII);
            op->tfv[(size_t)(7 * Q + q) * 4 + z] = sse_expf(vDD);
        }
    }
    op->rfv.assign((size_t)ncodes * Q * 4, 0.0f);
    for (int x = 0; x < ncodes; x++) {
        for (int q = 0; q < Q; q++) {
            for (int z = 0; z < 4; z++) {
                int k = z * Q + q + 1;
                float v = (k <= M) ? rsc[(size_t)x * (M + 1) + k] : ninf;
                op->rfv[((size_t)x * Q + q) * 4 + z] = sse_expf(v);
            }
        }
    }
    return op;
}

/* ---------------- striped f32 Forward -------------------------------- */

enum { XMX_E = 0, XMX_N, XMX_J, XMX_B, XMX_C, XMX_SCALE };

struct Fwd32 {
    int L = 0, Q = 0;
    /* 1 = streaming mode: dp holds only a 2-row window (rows i and
     * i-1/i+1, indexed modulo 2).  The f32 value stream is unchanged —
     * only storage differs — so xmx/totscale/fwdsc stay exact; dp rows
     * other than the window are NOT retained (decoding / trace
     * sampling require keep == 0). */
    int keep = 0;
    /* rows [L+1][Q][M,D,I][4] (or [2][...] when keep) */
    std::vector<float> dp;
    /* specials [L+1][6]: E,N,J,B,C,SCALE */
    std::vector<float> xmx;
    /* f32 cumulative log-scale ledger and final score, accumulated
     * exactly as the binary does (totscale stored f32, updated
     * totscale = f32((double)totscale + log(scale)); score =
     * f32(log((double)xC * Cmove) + (double)totscale)) */
    float totscale = 0.0f;
    float fwdsc = 0.0f;
    bool own_scales = false;   /* backward only: xB exceeded 1e16 */

    inline float *row(int i) {
        return &dp[(size_t)(keep ? (i & 1) : i) * Q * 12];
    }
    inline const float *row(int i) const {
        return &dp[(size_t)(keep ? (i & 1) : i) * Q * 12];
    }
    inline const float *vM(int i, int q) const { return row(i) + q * 12; }
    inline const float *vD(int i, int q) const {
        return row(i) + q * 12 + 4;
    }
    inline const float *vI(int i, int q) const {
        return row(i) + q * 12 + 8;
    }
    inline const float *xrow(int i) const { return &xmx[(size_t)i * 6]; }
};

inline void rshift(const float *src, float *dst) {
    dst[0] = 0.0f; dst[1] = src[0]; dst[2] = src[1]; dst[3] = src[2];
}

/* forward_engine (p7_Forward, full matrix), exact f32 stream.
 * stream=true keeps only a 2-row dp window (callers that need just
 * xmx/fwdsc); the value stream is identical. */
inline void forward_f32(const OProfile &om, const XF &xf,
                        const int32_t *codes, int L, Fwd32 *f,
                        bool stream = false) {
    int Q = om.Q;
    f->L = L; f->Q = Q;
    f->keep = stream ? 1 : 0;
    f->dp.assign((size_t)(stream ? 2 : L + 1) * Q * 12, 0.0f);
    f->xmx.assign((size_t)(L + 1) * 6, 0.0f);
    f->totscale = 0.0f;
    float *x0 = &f->xmx[0];
    x0[XMX_E] = 0.0f; x0[XMX_N] = 1.0f; x0[XMX_J] = 0.0f;
    x0[XMX_B] = xf.move[XF_N]; x0[XMX_C] = 0.0f; x0[XMX_SCALE] = 1.0f;

    double Nloop = (double)xf.loop[XF_N], Nmove = (double)xf.move[XF_N];
    double Jloop = (double)xf.loop[XF_J], Jmove = (double)xf.move[XF_J];
    double Cloop = (double)xf.loop[XF_C];
    double Eloop = (double)xf.loop[XF_E], Emove = (double)xf.move[XF_E];

    float xN = x0[XMX_N], xJ = x0[XMX_J], xB = x0[XMX_B], xC = x0[XMX_C];

    for (int i = 1; i <= L; i++) {
        const float *prev = f->row(i - 1);
        float *cur = f->row(i);
        int x = codes[i - 1];
        const float *rp = om.rf(x);
        float xEv[4] = {0.f, 0.f, 0.f, 0.f};
        float dcv[4] = {0.f, 0.f, 0.f, 0.f};
        float mpv[4], ipv[4], dpv[4];
        rshift(prev + (Q - 1) * 12, mpv);
        rshift(prev + (Q - 1) * 12 + 4, dpv);
        rshift(prev + (Q - 1) * 12 + 8, ipv);
        for (int q = 0; q < Q; q++) {
            const float *tBM = om.tf(q, TFV_BM);
            const float *tMM = om.tf(q, TFV_MM);
            const float *tIM = om.tf(q, TFV_IM);
            const float *tDM = om.tf(q, TFV_DM);
            const float *tMD = om.tf(q, TFV_MD);
            const float *tMI = om.tf(q, TFV_MI);
            const float *tII = om.tf(q, TFV_II);
            const float *pM = prev + q * 12;
            const float *pD = prev + q * 12 + 4;
            const float *pI = prev + q * 12 + 8;
            float *cM = cur + q * 12;
            float *cD = cur + q * 12 + 4;
            float *cI = cur + q * 12 + 8;
            float sv[4];
            for (int z = 0; z < 4; z++) {
                float s = xB * tBM[z];
                s = s + mpv[z] * tMM[z];
                s = s + ipv[z] * tIM[z];
                s = s + dpv[z] * tDM[z];
                s = s * rp[q * 4 + z];
                xEv[z] = xEv[z] + s;
                sv[z] = s;
            }
            for (int z = 0; z < 4; z++) {
                cM[z] = sv[z];
                cD[z] = dcv[z];
                /* I(i,q) sources the UNSHIFTED prev-row stripe q (the
                 * binary reloads mpv/ipv before the MI/II multiplies) */
                mpv[z] = pM[z]; dpv[z] = pD[z]; ipv[z] = pI[z];
                cI[z] = mpv[z] * tMI[z] + ipv[z] * tII[z];
                dcv[z] = sv[z] * tMD[z];
            }
        }
        /* first DD pass: extend M->D and D->D */
        {
            float t[4];
            rshift(dcv, t);
            for (int z = 0; z < 4; z++) dcv[z] = t[z];
            float *cD0 = cur + 4;
            for (int z = 0; z < 4; z++) cD0[z] = 0.0f;
            for (int q = 0; q < Q; q++) {
                float *cD = cur + q * 12 + 4;
                const float *tDD = om.tdd(q);
                for (int z = 0; z < 4; z++) {
                    dcv[z] = dcv[z] + cD[z];
                    cD[z] = dcv[z];
                    dcv[z] = cD[z] * tDD[z];
                }
            }
        }
        /* serialized DD passes (value-identical to both binary
         * branches; early break when no lane changes) */
        for (int j = 1; j < 4; j++) {
            float t[4];
            rshift(dcv, t);
            for (int z = 0; z < 4; z++) dcv[z] = t[z];
            bool changed = false;
            for (int q = 0; q < Q; q++) {
                float *cD = cur + q * 12 + 4;
                const float *tDD = om.tdd(q);
                for (int z = 0; z < 4; z++) {
                    float nv = dcv[z] + cD[z];
                    if (nv > cD[z]) changed = true;
                    cD[z] = nv;
                    dcv[z] = dcv[z] * tDD[z];
                }
            }
            if (!changed) break;
        }
        for (int q = 0; q < Q; q++) {
            const float *cD = cur + q * 12 + 4;
            for (int z = 0; z < 4; z++) xEv[z] = xEv[z] + cD[z];
        }
        /* hsum: (a0+a1)+(a2+a3) */
        float xE;
        {
            float b0 = xEv[0] + xEv[1];
            float b2 = xEv[2] + xEv[3];
            xE = b0 + b2;
        }
        /* specials in double, single rounding each (icc) */
        float nN = (float)((double)xN * Nloop);
        float nJ = (float)((double)xJ * Jloop + (double)xE * Eloop);
        float nC = (float)((double)xC * Cloop + (double)xE * Emove);
        float nB = (float)((double)nN * Nmove + (double)nJ * Jmove);
        float scale = 1.0f;
        if ((double)xE > 1.0e4) {
            double dxE = (double)xE;
            float inv = (float)(1.0 / dxE);
            for (int q = 0; q < Q; q++) {
                float *c = cur + q * 12;
                for (int z = 0; z < 12; z++) c[z] = c[z] * inv;
            }
            nN = (float)((double)nN / dxE);
            nC = (float)((double)nC / dxE);
            nJ = (float)((double)nJ / dxE);
            nB = (float)((double)nB / dxE);
            scale = xE;
            f->totscale = (float)((double)f->totscale + x_log(dxE));
            xE = 1.0f;
        }
        float *xr = &f->xmx[(size_t)i * 6];
        xr[XMX_E] = xE; xr[XMX_N] = nN; xr[XMX_J] = nJ;
        xr[XMX_B] = nB; xr[XMX_C] = nC; xr[XMX_SCALE] = scale;
        xN = nN; xJ = nJ; xB = nB; xC = nC;
    }
    f->fwdsc = (float)(x_log((double)xC * (double)xf.move[XF_C])
                       + (double)f->totscale);
}

/* ---------------- striped f32 Backward ------------------------------- */

/* p7_Backward (impl_sse backward_engine, full matrix), exact f32
 * stream as compiled (icc): specials accumulated in double and rounded
 * once per value; rows share the forward's per-row scales unless xB
 * exceeds 1e16 (then own scales, threshold 1e4); row L's divisions and
 * all rescale divisions are double-divides rounded once to f32.
 * Layout identical to Fwd32 ([M,D,I] per stripe + xmx rows). */
inline void backward_f32(const OProfile &om, const XF &xf,
                         const int32_t *codes, int L,
                         const Fwd32 &fwd, Fwd32 *b,
                         bool stream = false) {
    int Q = om.Q;
    b->L = L; b->Q = Q;
    b->keep = stream ? 1 : 0;
    b->dp.assign((size_t)(stream ? 2 : L + 1) * Q * 12, 0.0f);
    b->xmx.assign((size_t)(L + 1) * 6, 0.0f);

    double Nloop = (double)xf.loop[XF_N], Nmove = (double)xf.move[XF_N];
    double Jloop = (double)xf.loop[XF_J], Jmove = (double)xf.move[XF_J];
    double Cloop = (double)xf.loop[XF_C];
    double Eloop = (double)xf.loop[XF_E], Emove = (double)xf.move[XF_E];

    auto lshiftz = [](const float *src, float *dst) {
        dst[0] = src[1]; dst[1] = src[2]; dst[2] = src[3]; dst[3] = 0.0f;
    };

    /* ---- row L ---- */
    float xC = xf.move[XF_C];
    float xE = (float)((double)xC * Emove);
    float xJ = 0.0f, xN = 0.0f, xB = 0.0f;
    bool own_scales = false;
    double totscale = 0.0;
    {
        float *row = b->row(L);
        for (int q = 0; q < Q; q++) {
            for (int z = 0; z < 4; z++) {
                row[q * 12 + z] = xE;          /* M */
                row[q * 12 + 4 + z] = xE;      /* D */
                row[q * 12 + 8 + z] = 0.0f;    /* I */
            }
        }
        /* backward DD propagation along row L: pass 1 carries the
         * SERIALIZED updated D (full M->D + D->D extension); passes
         * 2-4 carry the pure DD product chain, each seeded with the
         * leftshift of the previous pass's final carry */
        float dcv[4];
        lshiftz(row + (Q - 1) * 12 + 4, dcv);
        for (int q = Q - 1; q >= 0; q--) {
            const float *tDD = om.tdd(q);
            float *D = row + q * 12 + 4;
            float prod[4];
            for (int z = 0; z < 4; z++) {
                prod[z] = dcv[z] * tDD[z];
                D[z] = D[z] + prod[z];
            }
            if (q > 0) std::memcpy(dcv, D, 16);
            else std::memcpy(dcv, prod, 16);
        }
        for (int j = 1; j < 4; j++) {
            float t[4];
            lshiftz(dcv, t);
            std::memcpy(dcv, t, 16);
            for (int q = Q - 1; q >= 0; q--) {
                const float *tDD = om.tdd(q);
                float *D = row + q * 12 + 4;
                for (int z = 0; z < 4; z++) {
                    dcv[z] = dcv[z] * tDD[z];
                    D[z] = D[z] + dcv[z];
                }
            }
        }
        /* bM(k) += bD(k+1)*t_md(k): stripe q pairs with stripe q+1
         * unshifted, wrapping to leftshift(stripe 0) at q = Q-1 */
        for (int q = Q - 1; q >= 0; q--) {
            const float *tMD = om.tf(q, TFV_MD);
            float *M = row + q * 12;
            float dsh[4];
            if (q == Q - 1) lshiftz(row + 0 * 12 + 4, dsh);
            else std::memcpy(dsh, row + (q + 1) * 12 + 4, 16);
            for (int z = 0; z < 4; z++)
                M[z] = M[z] + dsh[z] * tMD[z];
        }
        float scaleL = fwd.xmx[(size_t)L * 6 + XMX_SCALE];
        if ((double)scaleL > 1.0) {
            double s = (double)scaleL;
            float inv = (float)(1.0 / s);
            xE = (float)((double)xE / s);
            xC = (float)((double)xC / s);
            /* xJ/xB/xN are zero */
            float *r = row;
            for (int q = 0; q < Q; q++)
                for (int z = 0; z < 12; z++)
                    r[q * 12 + z] = r[q * 12 + z] * inv;
            totscale += (double)logf(scaleL);
        }
        float *xr = &b->xmx[(size_t)L * 6];
        xr[XMX_E] = xE; xr[XMX_N] = xN; xr[XMX_J] = xJ;
        xr[XMX_B] = xB; xr[XMX_C] = xC;
        xr[XMX_SCALE] = scaleL;
    }

    /* ---- rows L-1 .. 1 ---- */
    for (int i = L - 1; i >= 1; i--) {
        const float *dpp = b->row(i + 1);
        float *dpc = b->row(i);
        int x = codes[i];              /* dsq[i+1], 0-based codes[i] */
        const float *rp = om.rf(x);

        float mpv[4], tmmv[4], timv[4], tdmv[4];
        {
            float t[4];
            for (int z = 0; z < 4; z++)
                t[z] = dpp[0 * 12 + z] * rp[0 * 4 + z];
            lshiftz(t, mpv);
        }
        lshiftz(om.tf(0, TFV_MM), tmmv);
        lshiftz(om.tf(0, TFV_IM), timv);
        lshiftz(om.tf(0, TFV_DM), tdmv);
        float xBv[4] = {0.f, 0.f, 0.f, 0.f};
        for (int q = Q - 1; q >= 0; q--) {
            const float *ip = dpp + q * 12 + 8;
            const float *tII = om.tf(q, TFV_II);
            const float *tMI = om.tf(q, TFV_MI);
            float bI[4], bD[4], bM[4];
            for (int z = 0; z < 4; z++) {
                bI[z] = ip[z] * tII[z] + mpv[z] * timv[z];
                bD[z] = mpv[z] * tdmv[z];
                bM[z] = mpv[z] * tmmv[z] + ip[z] * tMI[z];
            }
            std::memcpy(dpc + q * 12 + 8, bI, 16);
            std::memcpy(dpc + q * 12 + 4, bD, 16);
            std::memcpy(dpc + q * 12, bM, 16);
            float Me[4];
            const float *Mn = dpp + q * 12;
            for (int z = 0; z < 4; z++)
                Me[z] = Mn[z] * rp[q * 4 + z];
            const float *tBM = om.tf(q, TFV_BM);
            for (int z = 0; z < 4; z++)
                xBv[z] = xBv[z] + Me[z] * tBM[z];
            std::memcpy(mpv, Me, 16);
            std::memcpy(tmmv, om.tf(q, TFV_MM), 16);
            std::memcpy(timv, om.tf(q, TFV_IM), 16);
            std::memcpy(tdmv, om.tf(q, TFV_DM), 16);
        }
        float b0 = xBv[0] + xBv[1];
        float b2 = xBv[2] + xBv[3];
        xB = b0 + b2;

        float nJ = (float)((double)xJ * Jloop + (double)xB * Jmove);
        float nC = (float)((double)xC * Cloop);
        float nN = (float)((double)xN * Nloop + (double)xB * Nmove);
        float nE = (float)((double)nJ * Eloop + (double)nC * Emove);

        /* D chain seeded with leftshift(D(0)+E); pass 1 carries the
         * serialized updated D and adds E into D and M; passes 2-4
         * carry the DD product chain seeded from the previous pass's
         * final carry */
        float dcv[4];
        {
            float t[4];
            for (int z = 0; z < 4; z++)
                t[z] = dpc[0 * 12 + 4 + z] + nE;
            lshiftz(t, dcv);
        }
        for (int q = Q - 1; q >= 0; q--) {
            const float *tDD = om.tdd(q);
            float *D = dpc + q * 12 + 4;
            float *M = dpc + q * 12;
            float prod[4], nv[4];
            for (int z = 0; z < 4; z++) {
                prod[z] = dcv[z] * tDD[z];
                nv[z] = (nE + prod[z]) + D[z];
            }
            for (int z = 0; z < 4; z++) M[z] = M[z] + nE;
            std::memcpy(D, nv, 16);
            if (q > 0) std::memcpy(dcv, nv, 16);
            else std::memcpy(dcv, prod, 16);
        }
        for (int j = 1; j < 4; j++) {
            float t[4];
            lshiftz(dcv, t);
            std::memcpy(dcv, t, 16);
            for (int q = Q - 1; q >= 0; q--) {
                const float *tDD = om.tdd(q);
                float *D = dpc + q * 12 + 4;
                for (int z = 0; z < 4; z++) {
                    dcv[z] = dcv[z] * tDD[z];
                    D[z] = D[z] + dcv[z];
                }
            }
        }
        {
            float dsh[4];
            for (int q = Q - 1; q >= 0; q--) {
                const float *tMD = om.tf(q, TFV_MD);
                float *M = dpc + q * 12;
                if (q == Q - 1) lshiftz(dpc + 0 * 12 + 4, dsh);
                else std::memcpy(dsh, dpc + (q + 1) * 12 + 4, 16);
                for (int z = 0; z < 4; z++)
                    M[z] = M[z] + dsh[z] * tMD[z];
            }
        }

        if ((double)xB > 1e16) own_scales = true;
        float scale_i;
        if (own_scales) {
            scale_i = ((double)xB > 1e4) ? xB : 1.0f;
        } else {
            scale_i = fwd.xmx[(size_t)i * 6 + XMX_SCALE];
        }
        if ((double)scale_i > 1.0) {
            double s = (double)scale_i;
            float inv = (float)(1.0 / s);
            nJ = (float)((double)nJ / s);
            nC = (float)((double)nC / s);
            nN = (float)((double)nN / s);
            nE = (float)((double)nE / s);
            xB = (float)((double)xB / s);
            for (int q = 0; q < Q; q++)
                for (int z = 0; z < 12; z++)
                    dpc[q * 12 + z] = dpc[q * 12 + z] * inv;
            totscale += std::log(s);
        }
        float *xr = &b->xmx[(size_t)i * 6];
        xr[XMX_E] = nE; xr[XMX_N] = nN; xr[XMX_J] = nJ;
        xr[XMX_B] = xB; xr[XMX_C] = nC;
        xr[XMX_SCALE] = scale_i;
        xJ = nJ; xC = nC; xN = nN;
    }

    /* ---- row 0 (specials only) ---- */
    {
        const float *dpp = b->row(1);
        int x = codes[0];
        const float *rp = om.rf(x);
        float xBv[4] = {0.f, 0.f, 0.f, 0.f};
        /* row 0 accumulates ASCENDING q (the row loop's B went
         * descending) — order matters for the f32 sum */
        for (int q = 0; q < Q; q++) {
            const float *Mn = dpp + q * 12;
            const float *tBM = om.tf(q, TFV_BM);
            for (int z = 0; z < 4; z++)
                xBv[z] = xBv[z] + Mn[z] * rp[q * 4 + z] * tBM[z];
        }
        float b0 = xBv[0] + xBv[1];
        float b2 = xBv[2] + xBv[3];
        xB = b0 + b2;
        float nN = (float)((double)xN * Nloop + (double)xB * Nmove);
        float *xr = &b->xmx[0];
        xr[XMX_E] = 0.0f; xr[XMX_N] = nN; xr[XMX_J] = 0.0f;
        xr[XMX_B] = xB; xr[XMX_C] = 0.0f;
        xr[XMX_SCALE] = 1.0f;
        b->xmx[0 + XMX_N] = nN;
    }
    /* totscale retained for callers via fwd-style recompute; the
     * backward score itself is log(xN(0)) + totscale (not stored) */
    (void)totscale;
    b->own_scales = own_scales;
}

/* ---------------- DomainDecoding (p7_domaindef.c) -------------------- */

/* p7_DomainDecoding, exact f32 (forward-shared scales only — returns
 * false when the backward took its own scales): fills mocc/btot/etot
 * rows 0..L. */
inline bool domain_decoding_f32(const XF &xf, const Fwd32 &f,
                                const Fwd32 &b, float *mocc,
                                float *btot, float *etot) {
    if (b.own_scales) return false;
    int L = f.L;
    float totr = 1.0f / b.xmx[0 * 6 + XMX_N];
    mocc[0] = btot[0] = etot[0] = 0.0f;
    for (int i = 1; i <= L; i++) {
        const float *fx1 = &f.xmx[(size_t)(i - 1) * 6];
        const float *fxi = &f.xmx[(size_t)i * 6];
        const float *bx1 = &b.xmx[(size_t)(i - 1) * 6];
        const float *bxi = &b.xmx[(size_t)i * 6];
        /* B term uses row i-1's scale lane (p7_DomainDecoding
         * 0x44d900-0x44d918: fwd ofs +0x14 = SCALE(i-1)); the E term
         * below uses row i's (+0x2c). They only differ at sparse-
         * rescale rows (xE > 1e4). */
        float dB = fx1[XMX_B] * totr * bx1[XMX_B] * fx1[XMX_SCALE];
        btot[i] = dB + btot[i - 1];
        float dE = fxi[XMX_E] * bxi[XMX_E] * fxi[XMX_SCALE] * totr;
        etot[i] = dE + etot[i - 1];
        float tN = xf.loop[XF_N] * fx1[XMX_N] * bxi[XMX_N];
        float tJ = xf.loop[XF_J] * fx1[XMX_J] * bxi[XMX_J];
        float tC = xf.loop[XF_C] * fx1[XMX_C] * bxi[XMX_C];
        float acc = 0.0f;
        acc = acc - tN;
        acc = acc - tJ;
        acc = acc - tC;
        mocc[i] = acc * totr + 1.0f;
    }
    return !std::isinf(totr);
}

/* ---------------- posterior decoding (impl_sse decoding.c) ----------- */

/* p7_Decoding: pp = f*b / total, exact f32 stream.  pp reuses the
 * Fwd32 layout (D plane zeroed, B/E specials zeroed).  Returns false
 * on the binary's eslERANGE condition (totr overflows to inf). */
inline bool decoding_f32(const OProfile &om, const XF &xf,
                         const Fwd32 &f, const Fwd32 &b, Fwd32 *pp,
                         bool bck_own_scales = false) {
    if (f.keep || b.keep) return false;   /* needs full matrices */
    int Q = om.Q;
    int L = f.L;
    pp->L = L; pp->Q = Q;
    pp->dp.assign((size_t)(L + 1) * Q * 12, 0.0f);
    pp->xmx.assign((size_t)(L + 1) * 6, 0.0f);
    float totr = 1.0f / b.xmx[0 * 6 + XMX_N];
    for (int i = 1; i <= L; i++) {
        float cellf = totr * f.xmx[(size_t)i * 6 + XMX_SCALE];
        const float *fr = &f.dp[(size_t)i * Q * 12];
        const float *br = &b.dp[(size_t)i * Q * 12];
        float *pr = &pp->dp[(size_t)i * Q * 12];
        for (int q = 0; q < Q; q++) {
            for (int z = 0; z < 4; z++) {
                pr[q * 12 + z] = fr[q * 12 + z] * br[q * 12 + z] * cellf;
                pr[q * 12 + 4 + z] = 0.0f;
                pr[q * 12 + 8 + z] =
                    fr[q * 12 + 8 + z] * br[q * 12 + 8 + z] * cellf;
            }
        }
        const float *fx1 = &f.xmx[(size_t)(i - 1) * 6];
        const float *bxi = &b.xmx[(size_t)i * 6];
        float *px = &pp->xmx[(size_t)i * 6];
        px[XMX_E] = 0.0f;
        px[XMX_N] = xf.loop[XF_N] * fx1[XMX_N] * bxi[XMX_N] * totr;
        px[XMX_J] = xf.loop[XF_J] * fx1[XMX_J] * bxi[XMX_J] * totr;
        px[XMX_C] = xf.loop[XF_C] * fx1[XMX_C] * bxi[XMX_C] * totr;
        px[XMX_B] = 0.0f;
        if (bck_own_scales) {
            float r = f.xmx[(size_t)i * 6 + XMX_SCALE]
                      / b.xmx[(size_t)i * 6 + XMX_SCALE];
            totr = totr * r;
        }
    }
    return !std::isinf(totr);
}

/* ---------------- null2 (impl_sse null2.c) --------------------------- */

/* p7_Null2_ByExpectation: null2[x] for canonical codes + degeneracy
 * averages, exact f32 stream.  pp is MODIFIED (row 0 becomes the
 * accumulator, matching the binary).  null2 has om.ncodes entries. */
inline void null2_by_expectation_f32(const OProfile &om, const XF &xf,
                                     Fwd32 *pp,
                                     const double *expand, int Kc,
                                     float *null2) {
    (void)xf;
    assert(!pp->keep && "null2_by_expectation_f32 needs full pp rows");
    int Q = om.Q;
    int Ld = pp->L;
    float *row0 = &pp->dp[0];
    const float *row1 = &pp->dp[(size_t)1 * Q * 12];
    std::memcpy(row0, row1, (size_t)Q * 12 * sizeof(float));
    float accN = pp->xmx[1 * 6 + XMX_N];
    float accJ = pp->xmx[1 * 6 + XMX_J];
    float accC = pp->xmx[1 * 6 + XMX_C];
    for (int i = 2; i <= Ld; i++) {
        const float *ri = &pp->dp[(size_t)i * Q * 12];
        for (int q = 0; q < Q; q++) {
            for (int z = 0; z < 4; z++) {
                row0[q * 12 + z] += ri[q * 12 + z];
                row0[q * 12 + 8 + z] += ri[q * 12 + 8 + z];
            }
        }
        accN += pp->xmx[(size_t)i * 6 + XMX_N];
        accJ += pp->xmx[(size_t)i * 6 + XMX_J];
        accC += pp->xmx[(size_t)i * 6 + XMX_C];
    }
    float inv = 1.0f / (float)Ld;
    for (int q = 0; q < Q; q++)
        for (int z = 0; z < 4; z++) {
            row0[q * 12 + z] *= inv;
            row0[q * 12 + 8 + z] *= inv;
        }
    accN = accN * inv;
    accC = accC * inv;
    accJ = accJ * inv;
    float xfactor = (accN + accC) + accJ;
    for (int x = 0; x < Kc; x++) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float *rp = om.rf(x);
        for (int q = 0; q < Q; q++) {
            for (int z = 0; z < 4; z++) {
                acc[z] = acc[z] + row0[q * 12 + z] * rp[q * 4 + z]
                         + row0[q * 12 + 8 + z];
            }
        }
        float b0 = acc[0] + acc[1];
        float b2 = acc[2] + acc[3];
        null2[x] = (b0 + b2) + xfactor;
    }
    /* esl_abc_FAvgScVec: degeneracies = unweighted f32 mean of their
     * member values; gap/nonres/missing = 1.0 */
    int ncodes = om.ncodes;
    for (int c = Kc + 1; c < ncodes; c++) {
        float s = 0.0f;
        int n = 0;
        for (int y = 0; y < Kc; y++)
            if (expand[(size_t)c * Kc + y] > 0.0) {
                s += null2[y];
                n++;
            }
        null2[c] = s / (float)n;
    }
    null2[Kc] = 1.0f;                    /* gap */
}

/* ---------------- FLogsum + null1 (p7_logsum.c / p7_bg.c) ------------ */

struct FLogsumTable {
    float tbl[16000];
    FLogsumTable() {
        for (int i = 0; i < 16000; i++)
            tbl[i] = (float)x_log(1.0 + std::exp((double)-i / 1000.0));
    }
};
inline float p7_flogsum(float a, float b) {
    static FLogsumTable T;
    float mx = a > b ? a : b;
    float mn = a > b ? b : a;
    if (std::isinf(mn) && mn < 0) return mx;
    if (mx - mn >= 15.7f) return mx;
    return mx + T.tbl[(int)((mx - mn) * 1000.0f)];
}

/* p7_bg_NullOne with p1 from p7_bg_SetLength: f32 p1, double logs,
 * one rounding. */
inline float null1_f32(int L) {
    float p1 = (float)L / (float)(L + 1);
    return (float)((double)(float)L * x_log((double)p1)
                   + x_log(1.0 - (double)p1));
}

/* ---------------- stochastic traceback (impl_sse/stotrace.c) --------- */

/* One sampled trace.  Rng must provide random() -> double in [0,1) and
 * fchoose(const float*, int) with esl_vec_FNorm + esl_rnd_FChoose
 * semantics.  SegT is any struct {int t, i, j, k, m}; StepT any
 * {char st; int k, i}.  Bookkeeping (segment emission, step recording)
 * matches the f64 sample_trace in domaindef_kernel.cpp. */
template <typename Rng, typename SegT, typename StepT>
inline void sample_trace_f32(Rng &rng, const OProfile &om, const XF &xf,
                             const Fwd32 &f, int t,
                             std::vector<SegT> *segs,
                             std::vector<StepT> *steps) {
    assert(!f.keep && "sample_trace_f32 needs a full (non-streamed) matrix");
    int L = f.L, Q = f.Q, M = om.M;
    int i = L;
    char st = 'C';
    int k = 0;
    int cur_end = 0, cur_kend = 0;
    float cand[4];
    const float *X = f.xmx.data();
    while (!(st == 'N' && i == 0)) {
        const float *xi = X + (size_t)i * 6;
        switch (st) {
        case 'C': {
            cand[0] = (i > 0) ? xf.loop[XF_C] * X[(size_t)(i - 1) * 6 + XMX_C]
                              : 0.0f;
            cand[1] = (xf.move[XF_E] * xi[XMX_E]) * xi[XMX_SCALE];
            if (rng.fchoose(cand, 2) == 0) i--; else st = 'E';
            break;
        }
        case 'J': {
            cand[0] = (i > 0) ? xf.loop[XF_J] * X[(size_t)(i - 1) * 6 + XMX_J]
                              : 0.0f;
            cand[1] = (xf.loop[XF_E] * xi[XMX_E]) * xi[XMX_SCALE];
            if (rng.fchoose(cand, 2) == 0) i--; else st = 'E';
            break;
        }
        case 'E': {
            /* one raw draw; walk M then D lanes per stripe; the double
             * accumulator wraps around without reset (binary behavior
             * when f32 rounding leaves cum short of the roll) */
            double roll = rng.random();
            float invE = 1.0f / xi[XMX_E];
            double cum = 0.0;
            int sel_k = -1;
            char sel_st = 'M';
            for (int guard = 0; guard < 16 && sel_k < 0; guard++) {
                for (int q = 0; q < Q && sel_k < 0; q++) {
                    const float *cm = f.vM(i, q);
                    for (int z = 0; z < 4; z++) {
                        float v = cm[z] * invE;
                        cum += (double)v;
                        if (cum > roll) {
                            sel_k = z * Q + q + 1; sel_st = 'M'; break;
                        }
                    }
                    if (sel_k >= 0) break;
                    const float *cd = f.vD(i, q);
                    for (int z = 0; z < 4; z++) {
                        float v = cd[z] * invE;
                        cum += (double)v;
                        if (cum > roll) {
                            sel_k = z * Q + q + 1; sel_st = 'D'; break;
                        }
                    }
                }
            }
            if (sel_k < 0 || sel_k > M) { sel_k = M; sel_st = 'M'; }
            st = sel_st; k = sel_k;
            /* domain hmm-end = k of the LAST M state (p7_trace_Index
             * ignores a trailing D run when the E-exit picked a D
             * cell); resolved at the first M visited walking back */
            cur_end = i; cur_kend = (sel_st == 'M') ? k : -1;
            break;
        }
        case 'M': {
            int q = (k - 1) % Q, r = (k - 1) / Q;
            float mpv[4], ipv[4], dpv[4];
            if (q > 0) {
                std::memcpy(mpv, f.vM(i - 1, q - 1), 16);
                std::memcpy(dpv, f.vD(i - 1, q - 1), 16);
                std::memcpy(ipv, f.vI(i - 1, q - 1), 16);
            } else {
                rshift(f.vM(i - 1, Q - 1), mpv);
                rshift(f.vD(i - 1, Q - 1), dpv);
                rshift(f.vI(i - 1, Q - 1), ipv);
            }
            float xB = X[(size_t)(i - 1) * 6 + XMX_B];
            cand[0] = xB * om.tf(q, TFV_BM)[r];
            cand[1] = mpv[r] * om.tf(q, TFV_MM)[r];
            cand[2] = ipv[r] * om.tf(q, TFV_IM)[r];
            cand[3] = dpv[r] * om.tf(q, TFV_DM)[r];
            if (cur_kend < 0) cur_kend = k;
            if (steps) steps->push_back({'M', k, i});
            int j = rng.fchoose(cand, 4);
            if (j == 0) {
                if (segs) segs->push_back({t, i, cur_end, k, cur_kend});
                st = 'B'; i--;
            } else if (j == 1) { st = 'M'; k--; i--; }
            else if (j == 2) { st = 'I'; k--; i--; }
            else { st = 'D'; k--; i--; }
            break;
        }
        case 'I': {
            int q = (k - 1) % Q, r = (k - 1) / Q;
            cand[0] = f.vM(i - 1, q)[r] * om.tf(q, TFV_MI)[r];
            cand[1] = f.vI(i - 1, q)[r] * om.tf(q, TFV_II)[r];
            if (steps) steps->push_back({'I', k, i});
            st = (rng.fchoose(cand, 2) == 0) ? 'M' : 'I';
            i--;
            break;
        }
        case 'D': {
            int q = (k - 2) % Q, r = (k - 2) / Q;
            cand[0] = f.vM(i, q)[r] * om.tf(q, TFV_MD)[r];
            cand[1] = f.vD(i, q)[r] * om.tdd(q)[r];
            if (rng.fchoose(cand, 2) == 0) { st = 'M'; k--; }
            else { st = 'D'; k--; }
            break;
        }
        case 'B': {
            cand[0] = xf.move[XF_N] * xi[XMX_N];
            cand[1] = xf.move[XF_J] * xi[XMX_J];
            st = (rng.fchoose(cand, 2) == 0) ? 'N' : 'J';
            break;
        }
        case 'N': i--; break;
        }
        if (i < 0) return;   /* degenerate; abandon trace */
    }
}

}  /* namespace stoch32 */

#endif  /* WITCH_TPU_STOCH_F32_H */
