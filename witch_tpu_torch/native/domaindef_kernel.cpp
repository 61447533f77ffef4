/* hmmsearch domain-definition engine: stochastic trace ensemble,
 * segment clustering, reporting gate and null2 accumulation.
 *
 * Native reimplementation of witch_tpu/hmm/trace_ensemble.py (semantics
 * reconstructed from the bundled HMMER 3.1b2 binary — constants and
 * control flow verified by disassembly; see docs/CALIBRATION.md and the
 * module docstring of trace_ensemble.py). One call resolves one region
 * of one (model, target) pair:
 *
 *   Forward (odds space, f64, per-row rescaling) on the region
 *   subsequence with the profile in multihit mode, length model = full
 *   sequence length; esl_randomness-fast stream re-seeded per region;
 *   nsamples stochastic tracebacks (candidate orders as in the binary:
 *   C=[Cloop,E] J=[Jloop,E] B=[N,J] I=[M,I] D=[M,D] M=[B,M,I,D], E via
 *   one raw draw over the striped M/D walk); segments -> single-linkage
 *   clustering (overlap >= 0.8 of smaller in seq AND model coords, and
 *   start- or end-diagonal within 4); min_posterior 0.25 support cut;
 *   >=0.8-overlap cluster dedup; endpoint-histogram envelopes; optional
 *   p7_Null2_ByTrace-style per-position null2 odds accumulation.
 *
 * CPython C API + numpy, no external dependencies.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <thread>
#include <atomic>
#include <memory>

#include "stoch_f32.h"

namespace {

constexpr double kRescaleHi = 1e250;

/* Alphabet tables for the exact-f32 trace path (set_alphabet glue):
 * degeneracy expansion [num_codes][Kc] and the f64 background the f64
 * log-odds were built with.  Empty until set_alphabet is called; the
 * f64 sampling path is used in that case. */
std::vector<double> g_alpha_expand;
std::vector<double> g_alpha_bg;
int g_alpha_ncodes = 0;
int g_alpha_kc = 0;

/* ---------------- esl randomness (fast LCG) ------------------------- */

static uint32_t jenkins_mix3(uint32_t a, uint32_t b, uint32_t c) {
    a -= b; a -= c; a ^= (c >> 13);
    b -= c; b -= a; b ^= (a << 8);
    c -= a; c -= b; c ^= (b >> 13);
    a -= b; a -= c; a ^= (c >> 12);
    b -= c; b -= a; b ^= (a << 16);
    c -= a; c -= b; c ^= (b >> 5);
    a -= b; a -= c; a ^= (c >> 3);
    b -= c; b -= a; b ^= (a << 10);
    c -= a; c -= b; c ^= (b >> 15);
    return c;
}

struct EselRng {
    uint32_t x;
    explicit EselRng(uint32_t seed) {
        x = jenkins_mix3(seed, 87654321u, 12345678u);
    }
    inline double random() {
        x = 69069u * x + 1u;   /* mod 2^32 via wraparound */
        return (double)x * (1.0 / 4294967296.0);
    }
    /* The binary calls esl_vec_FNorm (f32 in-order sum + f32 division)
     * on the candidate vector, then esl_rnd_FChoose (double-accumulated
     * CDF over the f32 entries / their double sum). Emulating the f32
     * normalization step matters only for boundary rolls, but those are
     * exactly where the marginal gate decisions live. */
    inline int fchoose(const float *p_in, int n) {
        float fs = 0.0f;
        for (int i = 0; i < n; i++) fs += p_in[i];
        float p[8];
        if (fs != 0.0f && n <= 8) {
            for (int i = 0; i < n; i++) p[i] = p_in[i] / fs;
        } else if (fs == 0.0f && n <= 8) {
            /* esl_vec_FNorm's zero-sum branch sets the uniform
             * distribution (FSet 1/n) before FChoose */
            for (int i = 0; i < n; i++) p[i] = 1.0f / (float)n;
        } else {
            for (int i = 0; i < n && i < 8; i++) p[i] = p_in[i];
        }
        double norm = 0.0;
        for (int i = 0; i < n; i++) norm += (double)p[i];
        double roll = random();
        double cum = 0.0;
        for (int i = 0; i < n; i++) {
            cum += (double)p[i];
            if (cum / norm > roll) return i;
        }
        return n - 1;
    }
};

/* ---------------- model view ---------------------------------------- */

struct Model {
    int M, K;
    const double *msc;                         /* [M+1, K] log odds */
    const double *t_mm, *t_mi, *t_md, *t_im, *t_ii, *t_dm, *t_dd, *bm;
    /* odds-space copies */
    std::vector<double> em;                    /* [M+1, K] */
    std::vector<double> emX;                   /* [K, M+1] transposed:
                                                  contiguous per-residue
                                                  rows for the DP loops */
    std::vector<double> mm, mi, md, im, ii, dm, dd, bmo;
    double loop, move;                         /* length model (odds) */
    /* exact-f32 striped profile for the trace ensembles (shared across
     * the per-target Model copies; built once pre-threading) */
    std::shared_ptr<const stoch32::OProfile> oprof;

    void build_oprof() {
        if (oprof || g_alpha_kc == 0 || K != g_alpha_ncodes) return;
        oprof = stoch32::build_oprofile(
            M, K, msc, t_mm, t_mi, t_md, t_im, t_ii, t_dm, t_dd,
            g_alpha_expand.data(), g_alpha_bg.data(), g_alpha_kc);
    }

    void set_length(int Lseq, bool multihit) {
        double pmove = (multihit ? 3.0 : 2.0)
                     / ((double)Lseq + (multihit ? 3.0 : 2.0));
        loop = 1.0 - pmove;
        move = pmove;
    }

    void prepare(int Lseq) {
        em.resize((size_t)(M + 1) * K);
        for (size_t i = 0; i < em.size(); i++) em[i] = std::exp(msc[i]);
        emX.resize((size_t)K * (M + 1));
        for (int k = 0; k <= M; k++)
            for (int x = 0; x < K; x++)
                emX[(size_t)x * (M + 1) + k] = em[(size_t)k * K + x];
        auto cv = [&](const double *src, std::vector<double> &dst) {
            dst.resize(M + 1);
            for (int k = 0; k <= M; k++) dst[k] = std::exp(src[k]);
        };
        cv(t_mm, mm); cv(t_mi, mi); cv(t_md, md); cv(t_im, im);
        cv(t_ii, ii); cv(t_dm, dm); cv(t_dd, dd); cv(bm, bmo);
        set_length(Lseq, true);
    }
};

/* ---------------- forward in odds space ------------------------------ */

/* Uninitialized growable f64 buffer: the DP matrices are written row by
 * row, so zero-filling them up front (std::vector assign/resize) wastes
 * ~40% of the forward/backward wall time in pure memset. Callers zero
 * only the boundary cells they actually read. */
struct Darr {
    std::unique_ptr<double[]> p;
    size_t cap = 0;
    void alloc(size_t m) {
        if (m > cap) { p.reset(new double[m]); cap = m; }
    }
    inline double &operator[](size_t i) { return p[i]; }
    inline const double &operator[](size_t i) const { return p[i]; }
    inline double *data() { return p.get(); }
    inline const double *data() const { return p.get(); }
};

#ifdef __AVX512F__
#include <immintrin.h>
#define WT_ROWS_AVX512 1
#endif

/* Vectorized row primitives for the odds-space profile DP. Elementwise
 * expressions match the scalar fallbacks; reduction order differs
 * (8-lane partial sums), which moves results by <= a few ulps — the
 * printed-score / gate tolerances are revalidated by the full-grid
 * grader (scripts/grade_scores.py) and the golden tiers. */

/* cm[k] = (pm[k-1]*mm[k-1] + pi[k-1]*im[k-1] + pd[k-1]*dm[k-1]
 *          + Bprev*bmo[k]) * ex[k],  k in [1, M]; returns sum(cm). */
static inline double row_fwd_m(const double *pm, const double *pi,
                               const double *pd, const double *mm,
                               const double *im, const double *dm,
                               const double *bmo, const double *ex,
                               double Bprev, double *cm, int M) {
    int k = 1;
    double s = 0.0;
#ifdef WT_ROWS_AVX512
    __m512d vB = _mm512_set1_pd(Bprev);
    __m512d acc = _mm512_setzero_pd();
    for (; k + 7 <= M; k += 8) {
        __m512d a = _mm512_mul_pd(_mm512_loadu_pd(pm + k - 1),
                                  _mm512_loadu_pd(mm + k - 1));
        a = _mm512_fmadd_pd(_mm512_loadu_pd(pi + k - 1),
                            _mm512_loadu_pd(im + k - 1), a);
        a = _mm512_fmadd_pd(_mm512_loadu_pd(pd + k - 1),
                            _mm512_loadu_pd(dm + k - 1), a);
        a = _mm512_fmadd_pd(vB, _mm512_loadu_pd(bmo + k), a);
        a = _mm512_mul_pd(a, _mm512_loadu_pd(ex + k));
        _mm512_storeu_pd(cm + k, a);
        acc = _mm512_add_pd(acc, a);
    }
    s = _mm512_reduce_add_pd(acc);
#endif
    for (; k <= M; k++) {
        double v = (pm[k - 1] * mm[k - 1] + pi[k - 1] * im[k - 1]
                    + pd[k - 1] * dm[k - 1] + Bprev * bmo[k]) * ex[k];
        cm[k] = v;
        s += v;
    }
    return s;
}

/* ci[k] = pm[k]*mi[k] + pi[k]*ii[k], k in [1, M-1]; ci[0] = ci[M] = 0. */
static inline void row_fwd_i(const double *pm, const double *pi,
                             const double *mi, const double *ii,
                             double *ci, int M) {
    ci[0] = 0.0;
    int k = 1;
#ifdef WT_ROWS_AVX512
    for (; k + 7 <= M - 1; k += 8) {
        __m512d a = _mm512_mul_pd(_mm512_loadu_pd(pm + k),
                                  _mm512_loadu_pd(mi + k));
        a = _mm512_fmadd_pd(_mm512_loadu_pd(pi + k),
                            _mm512_loadu_pd(ii + k), a);
        _mm512_storeu_pd(ci + k, a);
    }
#endif
    for (; k < M; k++)
        ci[k] = pm[k] * mi[k] + pi[k] * ii[k];
    ci[M] = 0.0;
}

/* sum_k bmo[k]*ex[k]*Mn[k], k in [1, M]. */
static inline double row_dot3(const double *bmo, const double *ex,
                              const double *Mn, int M) {
    int k = 1;
    double s = 0.0;
#ifdef WT_ROWS_AVX512
    __m512d acc = _mm512_setzero_pd();
    for (; k + 7 <= M; k += 8) {
        __m512d a = _mm512_mul_pd(_mm512_loadu_pd(bmo + k),
                                  _mm512_loadu_pd(ex + k));
        acc = _mm512_fmadd_pd(a, _mm512_loadu_pd(Mn + k), acc);
    }
    s = _mm512_reduce_add_pd(acc);
#endif
    for (; k <= M; k++) s += bmo[k] * ex[k] * Mn[k];
    return s;
}

/* Backward M/I row given the D chain:
 *   mnx    = Mn[k+1]*ex[k+1]
 *   bm[k]  = E + mnx*mm[k] + In[k]*mi[k] + Dk[k+1]*md[k]   (k < M)
 *   bi[k]  = mnx*im[k] + In[k]*ii[k]                        (k < M)
 *   bm[M]  = E; bi[M] = 0; bm[0] = bi[0] = 0.
 * Returns max over bm[1..M]. */
static inline double row_bck_mi(const double *Mn, const double *In,
                                const double *ex, const double *mm,
                                const double *mi, const double *md,
                                const double *im, const double *ii,
                                const double *Dk, double E,
                                double *bm_, double *bi_, int M) {
    bm_[0] = 0.0;
    bi_[0] = 0.0;
    double mx = E;
    int k = 1;
#ifdef WT_ROWS_AVX512
    __m512d vE = _mm512_set1_pd(E);
    __m512d vmx = vE;
    for (; k + 7 <= M - 1; k += 8) {
        __m512d mnx = _mm512_mul_pd(_mm512_loadu_pd(Mn + k + 1),
                                    _mm512_loadu_pd(ex + k + 1));
        __m512d in = _mm512_loadu_pd(In + k);
        __m512d v = _mm512_fmadd_pd(mnx, _mm512_loadu_pd(mm + k), vE);
        v = _mm512_fmadd_pd(in, _mm512_loadu_pd(mi + k), v);
        v = _mm512_fmadd_pd(_mm512_loadu_pd(Dk + k + 1),
                            _mm512_loadu_pd(md + k), v);
        _mm512_storeu_pd(bm_ + k, v);
        vmx = _mm512_max_pd(vmx, v);
        __m512d w = _mm512_mul_pd(mnx, _mm512_loadu_pd(im + k));
        w = _mm512_fmadd_pd(in, _mm512_loadu_pd(ii + k), w);
        _mm512_storeu_pd(bi_ + k, w);
    }
    mx = _mm512_reduce_max_pd(vmx);
#endif
    for (; k < M; k++) {
        double mnx = Mn[k + 1] * ex[k + 1];
        double v = E + mnx * mm[k] + In[k] * mi[k] + Dk[k + 1] * md[k];
        bm_[k] = v;
        bi_[k] = mnx * im[k] + In[k] * ii[k];
        if (v > mx) mx = v;
    }
    bm_[M] = E;
    bi_[M] = 0.0;
    return mx;
}

/* Backward D chain (right-to-left, serial):
 *   Dk[M] = E; Dk[k] = Mn[k+1]*ex[k+1]*dm[k] + Dk[k+1]*dd[k] + E. */
static inline void row_bck_dchain(const double *Mn, const double *ex,
                                  const double *dm, const double *dd,
                                  double E, double *Dk, int M) {
    Dk[M] = E;
    for (int k = M - 1; k >= 1; k--)
        Dk[k] = Mn[k + 1] * ex[k + 1] * dm[k] + Dk[k + 1] * dd[k] + E;
}

/* arr[0..M] *= inv (rescale) */
static inline void row_scale(double *a, double inv, int M) {
    int k = 0;
#ifdef WT_ROWS_AVX512
    __m512d vi = _mm512_set1_pd(inv);
    for (; k + 7 <= M; k += 8)
        _mm512_storeu_pd(a + k,
                         _mm512_mul_pd(_mm512_loadu_pd(a + k), vi));
#endif
    for (; k <= M; k++) a[k] *= inv;
}

struct Fwd {
    int L, M;
    /* row-major [L+1][M+1]; row scales in log space */
    Darr Mx, Ix, Dx;
    std::vector<double> N, B, E, J, C;
    std::vector<double> scale_log;             /* cumulative per row */

    void alloc_rows(int L_, int M_, bool with_d = true) {
        L = L_; M = M_;
        size_t sz = (size_t)(L + 1) * (M + 1);
        Mx.alloc(sz); Ix.alloc(sz);
        if (with_d) Dx.alloc(sz);
        /* row 0 is the DP boundary (read as the previous row at i=1
         * and by the stochastic traceback) */
        for (int k = 0; k <= M; k++) {
            Mx[k] = 0.0; Ix[k] = 0.0;
            if (with_d) Dx[k] = 0.0;
        }
        N.assign(L + 1, 0.0); B.assign(L + 1, 0.0); E.assign(L + 1, 0.0);
        J.assign(L + 1, 0.0); C.assign(L + 1, 0.0);
        scale_log.assign(L + 1, 0.0);
    }

    inline double *rowM(int i) { return &Mx[(size_t)i * (M + 1)]; }
    inline double *rowI(int i) { return &Ix[(size_t)i * (M + 1)]; }
    inline double *rowD(int i) { return &Dx[(size_t)i * (M + 1)]; }
    inline const double *rowM(int i) const { return &Mx[(size_t)i * (M + 1)]; }
    inline const double *rowI(int i) const { return &Ix[(size_t)i * (M + 1)]; }
    inline const double *rowD(int i) const { return &Dx[(size_t)i * (M + 1)]; }
};

static void forward_region(const Model &m, const int32_t *codes, int L,
                           Fwd *f) {
    int M = m.M;
    f->alloc_rows(L, M);
    f->N[0] = 1.0;
    f->B[0] = m.move;

    for (int i = 1; i <= L; i++) {
        const double *pm = f->rowM(i - 1);
        const double *pi = f->rowI(i - 1);
        const double *pd = f->rowD(i - 1);
        double *cm = f->rowM(i);
        double *ci = f->rowI(i);
        double *cd = f->rowD(i);
        int x = codes[i - 1];
        const double *ex = &m.emX[(size_t)x * (M + 1)];
        double Bprev = f->B[i - 1];
        cm[0] = 0.0;
        double esum = row_fwd_m(pm, pi, pd, m.mm.data(), m.im.data(),
                                m.dm.data(), m.bmo.data(), ex, Bprev,
                                cm, M);
        row_fwd_i(pm, pi, m.mi.data(), m.ii.data(), ci, M);
        cd[0] = cd[1] = 0.0;
        for (int k = 2; k <= M; k++) {
            cd[k] = cm[k - 1] * m.md[k - 1] + cd[k - 1] * m.dd[k - 1];
            esum += cd[k];
        }
        f->E[i] = esum;
        f->J[i] = f->J[i - 1] * m.loop + esum * 0.5;
        f->C[i] = f->C[i - 1] * m.loop + esum * 0.5;
        f->N[i] = f->N[i - 1] * m.loop;
        f->B[i] = f->N[i] * m.move + f->J[i] * m.move;
        f->scale_log[i] = f->scale_log[i - 1];
        /* rescale every row (odds dynamic range exceeds f64 on long
           weak pairs; unconditional scaling keeps rows O(1)) */
        double rs = esum > 0.0 ? esum : f->C[i];
        if (rs > 0.0 && (rs > 1e3 || rs < 1e-3)) {
            double inv = 1.0 / rs;
            for (int k = 0; k <= M; k++) {
                cm[k] *= inv; ci[k] *= inv; cd[k] *= inv;
            }
            f->E[i] *= inv; f->J[i] *= inv; f->C[i] *= inv;
            f->N[i] *= inv; f->B[i] *= inv;
            f->scale_log[i] += std::log(rs);
        }
    }
}

/* scale ratio exp(scale_log[a] - scale_log[b]) for cross-row candidates */
static inline double sratio(const Fwd &f, int a, int b) {
    double d = f.scale_log[a] - f.scale_log[b];
    return d == 0.0 ? 1.0 : std::exp(d);
}

/* ---------------- stochastic traceback ------------------------------- */

struct Seg { int t, i, j, k, m; };

struct TraceStep { char st; int k, i; };   /* st: M/I/D only recorded */

/* Sample one trace; push domains into segs (local 1-based coords).
 * If steps != nullptr, record the model-state visits with their
 * emission positions for null2 accumulation. */
static void sample_trace(EselRng &rng, const Model &mo, const Fwd &f,
                         int t, std::vector<Seg> *segs,
                         std::vector<TraceStep> *steps) {
    int L = f.L, M = f.M;
    int Q = (M + 3) / 4;
    if (Q < 2) Q = 2;
    int i = L;
    char st = 'C';
    int k = 0;
    int cur_end = 0, cur_kend = 0;
    float cand[4];
    while (!(st == 'N' && i == 0)) {
        switch (st) {
        case 'C': {
            cand[0] = (i > 0) ? (float)(f.C[i - 1] * mo.loop *
                                        sratio(f, i - 1, i)) : 0.0f;
            cand[1] = (float)(f.E[i] * 0.5);
            if (rng.fchoose(cand, 2) == 0) i--; else st = 'E';
            break;
        }
        case 'J': {
            cand[0] = (i > 0) ? (float)(f.J[i - 1] * mo.loop *
                                        sratio(f, i - 1, i)) : 0.0f;
            cand[1] = (float)(f.E[i] * 0.5);
            if (rng.fchoose(cand, 2) == 0) i--; else st = 'E';
            break;
        }
        case 'E': {
            /* one raw draw; walk M then D cells per striped q block */
            const double *cm = &f.Mx[(size_t)i * (M + 1)];
            const double *cd = &f.Dx[(size_t)i * (M + 1)];
            double invE = 1.0 / f.E[i];
            double roll = rng.random();
            double cum = 0.0;
            int sel_k = -1;
            char sel_st = 'M';
            for (int q = 0; q < Q && sel_k < 0; q++) {
                for (int z = 0; z < 4; z++) {
                    int kk = z * Q + q + 1;
                    double v = (kk <= M) ? cm[kk] * invE : 0.0;
                    cum += (double)(float)v;
                    if (cum > roll) { sel_k = kk; sel_st = 'M'; break; }
                }
                if (sel_k >= 0) break;
                for (int z = 0; z < 4; z++) {
                    int kk = z * Q + q + 1;
                    double v = (kk <= M && kk >= 2) ? cd[kk] * invE : 0.0;
                    cum += (double)(float)v;
                    if (cum > roll) { sel_k = kk; sel_st = 'D'; break; }
                }
            }
            if (sel_k < 0) { sel_k = M; sel_st = 'M'; }
            st = sel_st; k = sel_k;
            /* domain hmm-end = k of the LAST M state (p7_trace_Index
             * ignores a trailing D run off an E-exit D cell) */
            cur_end = i; cur_kend = (sel_st == 'M') ? k : -1;
            break;
        }
        case 'M': {
            const double *pm = f.Mx.data() + (size_t)(i - 1) * (M + 1);
            const double *pi2 = f.Ix.data() + (size_t)(i - 1) * (M + 1);
            const double *pd = f.Dx.data() + (size_t)(i - 1) * (M + 1);
            double sr = sratio(f, i - 1, i);
            /* binary's candidate order: [B, M, I, D] */
            cand[0] = (float)(f.B[i - 1] * mo.bmo[k] * sr);
            cand[1] = (k > 1) ? (float)(pm[k - 1] * mo.mm[k - 1] * sr)
                              : 0.0f;
            cand[2] = (k > 1) ? (float)(pi2[k - 1] * mo.im[k - 1] * sr)
                              : 0.0f;
            cand[3] = (k > 1) ? (float)(pd[k - 1] * mo.dm[k - 1] * sr)
                              : 0.0f;
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
            const double *pm = f.Mx.data() + (size_t)(i - 1) * (M + 1);
            const double *pi2 = f.Ix.data() + (size_t)(i - 1) * (M + 1);
            cand[0] = (float)(pm[k] * mo.mi[k]);
            cand[1] = (float)(pi2[k] * mo.ii[k]);
            if (steps) steps->push_back({'I', k, i});
            st = (rng.fchoose(cand, 2) == 0) ? 'M' : 'I';
            i--;
            break;
        }
        case 'D': {
            const double *cm = f.Mx.data() + (size_t)i * (M + 1);
            const double *cd = f.Dx.data() + (size_t)i * (M + 1);
            cand[0] = (float)(cm[k - 1] * mo.md[k - 1]);
            cand[1] = (float)(cd[k - 1] * mo.dd[k - 1]);
            if (rng.fchoose(cand, 2) == 0) { st = 'M'; k--; }
            else { st = 'D'; k--; }
            break;
        }
        case 'B': {
            cand[0] = (float)(f.N[i]);
            cand[1] = (float)(f.J[i]);
            st = (rng.fchoose(cand, 2) == 0) ? 'N' : 'J';
            break;
        }
        case 'N': i--; break;
        }
        if (i < 0) return;   /* degenerate; abandon trace */
    }
}

/* ---------------- clustering ---------------------------------------- */

struct Cluster {
    int i, j, k, m, nsamp, nseg;
    double post;
    std::vector<int> members;
};

struct DSU {
    std::vector<int> p;
    explicit DSU(int n) : p(n) { for (int i = 0; i < n; i++) p[i] = i; }
    int find(int a) { while (p[a] != a) { p[a] = p[p[a]]; a = p[a]; } return a; }
    void unite(int a, int b) { int ra = find(a), rb = find(b); if (ra != rb) p[ra] = rb; }
};

static int consensus(const std::vector<int> &vals, int thr, bool lo_side) {
    int lo = *std::min_element(vals.begin(), vals.end());
    int hi = *std::max_element(vals.begin(), vals.end());
    std::vector<int> hist(hi - lo + 1, 0);
    for (int v : vals) hist[v - lo]++;
    if (lo_side) {
        for (int v = 0; v < (int)hist.size(); v++)
            if (hist[v] >= thr) return lo + v;
    } else {
        for (int v = (int)hist.size() - 1; v >= 0; v--)
            if (hist[v] >= thr) return lo + v;
    }
    return lo + (int)(std::max_element(hist.begin(), hist.end())
                      - hist.begin());
}

static std::vector<Cluster> cluster_segments(const std::vector<Seg> &segs,
                                             int nsamples) {
    int n = (int)segs.size();
    std::vector<Cluster> out;
    if (!n) return out;
    DSU dsu(n);
    for (int a = 0; a < n; a++) {
        const Seg &sa = segs[a];
        for (int b = a + 1; b < n; b++) {
            if (dsu.find(a) == dsu.find(b)) continue;
            const Seg &sb = segs[b];
            /* link_spsamples semantics (verified by calling the bundled
             * binary's own predicate on crafted pairs): seq overlap is
             * INCLUSIVE (+1) but the hmm-coordinate overlap is
             * EXCLUSIVE (min_m - max_k, no +1) — an upstream quirk —
             * both tested as f32 divisions nov/n < 0.8f over the
             * inclusive min length */
            int ov = std::min(sa.j, sb.j) - std::max(sa.i, sb.i) + 1;
            int la = sa.j - sa.i + 1, lb = sb.j - sb.i + 1;
            if ((float)ov / (float)std::min(la, lb) < 0.8f) continue;
            int ovk = std::min(sa.m, sb.m) - std::max(sa.k, sb.k);
            int ka = sa.m - sa.k + 1, kb = sb.m - sb.k + 1;
            if ((float)ovk / (float)std::min(ka, kb) < 0.8f) continue;
            if (std::abs((sa.i - sa.k) - (sb.i - sb.k)) > 4 &&
                std::abs((sa.j - sa.m) - (sb.j - sb.m)) > 4) continue;
            dsu.unite(a, b);
        }
    }
    /* groups in first-seen order */
    std::vector<int> root_order;
    std::vector<std::vector<int>> groups;
    std::vector<int> root_of(n, -1);
    for (int a = 0; a < n; a++) {
        int r = dsu.find(a);
        if (root_of[r] < 0) {
            root_of[r] = (int)groups.size();
            groups.emplace_back();
        }
        groups[root_of[r]].push_back(a);
    }
    for (auto &g : groups) {
        int nsamp = 0, last = -1;
        for (int a : g) {                 /* members are sample-ordered */
            if (segs[a].t != last) { nsamp++; last = segs[a].t; }
        }
        double post = (double)nsamp / (double)nsamples;
        if ((float)post < 0.25f) continue;
        int thr = (int)std::ceil((float)nsamp * 0.02f);
        std::vector<int> is, js, ks, ms;
        for (int a : g) {
            is.push_back(segs[a].i); js.push_back(segs[a].j);
            ks.push_back(segs[a].k); ms.push_back(segs[a].m);
        }
        Cluster c;
        c.i = consensus(is, thr, true);
        c.j = consensus(js, thr, false);
        c.k = consensus(ks, thr, true);
        c.m = consensus(ms, thr, false);
        c.post = post; c.nsamp = nsamp; c.nseg = (int)g.size();
        out.push_back(std::move(c));
    }
    /* overlap dedup (seq axis; keep higher posterior, earlier dies on
       ties) */
    std::vector<char> dead(out.size(), 0);
    for (size_t a = 0; a < out.size(); a++) {
        if (dead[a]) continue;
        for (size_t b = a + 1; b < out.size(); b++) {
            if (dead[b]) continue;
            int ov = std::min(out[a].j, out[b].j)
                   - std::max(out[a].i, out[b].i) + 1;
            if (ov <= 0) continue;
            int la = out[a].j - out[a].i + 1, lb = out[b].j - out[b].i + 1;
            if ((double)ov / (double)std::min(la, lb) >= 0.8) {
                if (out[a].post > out[b].post) dead[b] = 1;
                else { dead[a] = 1; break; }
            }
        }
    }
    std::vector<Cluster> kept;
    for (size_t a = 0; a < out.size(); a++)
        if (!dead[a]) kept.push_back(std::move(out[a]));
    return kept;
}


/* ---------------- full-target evaluation ----------------------------- */

/* Backward pass (odds space, per-row rescaling), multihit, length model
 * already set on the Model. Mirrors forward_ref.backward_matrices. */
struct Bck {
    int L, M;
    Darr Mx, Ix;                        /* rows [L+1][M+1] */
    std::vector<double> N, B, E, J, C;
    std::vector<double> scale_log;
    void alloc_rows(int L_, int M_) {
        L = L_; M = M_;
        size_t sz = (size_t)(L + 1) * (M + 1);
        Mx.alloc(sz); Ix.alloc(sz);
        /* row L's I row is the recursion boundary (read as In at
         * i = L-1); its M row is fully written by callers */
        double *iL = &Ix[(size_t)L * (M + 1)];
        for (int k = 0; k <= M; k++) iL[k] = 0.0;
        N.assign(L + 1, 0.0); B.assign(L + 1, 0.0); E.assign(L + 1, 0.0);
        J.assign(L + 1, 0.0); C.assign(L + 1, 0.0);
        scale_log.assign(L + 1, 0.0);
    }
    inline double *rowM(int i) { return &Mx[(size_t)i * (M + 1)]; }
    inline double *rowI(int i) { return &Ix[(size_t)i * (M + 1)]; }
};

static void backward_full(const Model &m, const int32_t *codes, int L,
                          Bck *b) {
    int M = m.M;
    b->alloc_rows(L, M);
    std::vector<double> Dk(M + 1, 0.0);
    double eloop = 0.5, emove = 0.5;    /* multihit */
    b->C[L] = m.move;
    b->E[L] = b->C[L] * emove;
    /* row L: deletes still chain to E without emitting, so
       M_b[L,k] = E + D_b[L,k+1]*tmd[k] with
       D_b[L,k] = D_b[L,k+1]*tdd[k] + E */
    {
        Dk[M] = b->E[L];
        for (int k = M - 1; k >= 1; k--)
            Dk[k] = Dk[k + 1] * m.dd[k] + b->E[L];
        double *bm_ = b->rowM(L);
        bm_[0] = 0.0;
        for (int k = 1; k <= M; k++)
            bm_[k] = b->E[L] + (k < M ? Dk[k + 1] * m.md[k] : 0.0);
    }
    for (int i = L - 1; i >= 0; i--) {
        const double *Mn = b->rowM(i + 1);
        const double *In = b->rowI(i + 1);
        int x = codes[i];
        const double *ex = &m.emX[(size_t)x * (M + 1)];
        double Bv = row_dot3(m.bmo.data(), ex, Mn, M);
        b->B[i] = Bv;
        b->N[i] = b->N[i + 1] * m.loop + Bv * m.move;
        b->J[i] = b->J[i + 1] * m.loop + Bv * m.move;
        b->C[i] = b->C[i + 1] * m.loop;
        b->E[i] = b->C[i] * emove + b->J[i] * eloop;
        /* D chain right-to-left: D_k = Mn[k+1]*em*tdm[k] + D_{k+1}*tdd[k]
           + E (E exit from D) */
        row_bck_dchain(Mn, ex, m.dm.data(), m.dd.data(), b->E[i],
                       Dk.data(), M);
        double *bm_ = b->rowM(i);
        double *bi_ = b->rowI(i);
        double mx = row_bck_mi(Mn, In, ex, m.mm.data(), m.mi.data(),
                               m.md.data(), m.im.data(), m.ii.data(),
                               Dk.data(), b->E[i], bm_, bi_, M);
        b->scale_log[i] = b->scale_log[i + 1];
        if (mx > 0.0 && (mx > 1e3 || mx < 1e-3)) {
            double inv = 1.0 / mx;
            row_scale(bm_, inv, M);
            row_scale(bi_, inv, M);
            b->N[i] *= inv; b->B[i] *= inv; b->E[i] *= inv;
            b->J[i] *= inv; b->C[i] *= inv;
            row_scale(Dk.data(), inv, M);
            b->scale_log[i] += std::log(mx);
        }
    }
}

struct Region { int i, j; };

/* Region detection (p7_domaindef posterior heuristics; rt1/rt2 in f32
 * as the binary compares). mocc/dB/dE are [L+1]. */
static std::vector<Region> find_regions_c(const std::vector<double> &mocc,
                                          const std::vector<double> &dB,
                                          const std::vector<double> &dE,
                                          int L) {
    std::vector<Region> out;
    int i2 = -1;
    bool trig = false;
    for (int i = 1; i <= L; i++) {
        float mo = (float)mocc[i];
        if (!trig) {
            if (mo - (float)dB[i] < 0.10f) i2 = i;
            else if (i2 == -1) i2 = i;
            if (mo >= 0.25f) trig = true;
        } else if (mo - (float)dE[i] < 0.10f) {
            out.push_back({i2 < 1 ? 1 : i2, i});
            i2 = -1;
            trig = false;
        }
    }
    if (trig) out.push_back({i2 < 1 ? 1 : i2, L});
    return out;
}

/* Bit-exact region scan on the binary's own f32 mocc/btot/etot rows.
 * The binary's low-mass test (hmmsearch 0x449299-0x4492b2) is
 * (mocc[i] - btot[i]) + btot[i-1] < rt2 — differences of the
 * CUMULATIVE f32 btot/etot rows in that exact operation order, not
 * the fresh per-position B/E posterior.  Accumulated rounding in the
 * running sums shifts knife-edge region boundaries by one vs the
 * fresh-posterior variant (find_regions_c). */
static std::vector<Region> find_regions_f32(const float *mocc,
                                            const float *btot,
                                            const float *etot, int L) {
    std::vector<Region> out;
    int i2 = -1;
    bool trig = false;
    for (int i = 1; i <= L; i++) {
        float mo = mocc[i];
        if (!trig) {
            if ((mo - btot[i]) + btot[i - 1] < 0.10f) i2 = i;
            else if (i2 == -1) i2 = i;
            if (mo >= 0.25f) trig = true;
        } else if ((mo - etot[i]) + etot[i - 1] < 0.10f) {
            out.push_back({i2 < 1 ? 1 : i2, i});
            i2 = -1;
            trig = false;
        }
    }
    if (trig) out.push_back({i2 < 1 ? 1 : i2, L});
    return out;
}

/* Per-target full evaluation. Returns gate info and optional null2.
 * n2sc (log odds per position, 0 outside envelopes) has length L+1. */
struct TargetResult {
    int nregions = 0;
    int nenvelopes = 0;
    double seqbias_nats = 0.0;          /* FLogsum(0, ln w + sum n2sc) */
    double fwd_nats = 0.0;              /* full-sequence Forward */
    /* p7_pipeline.c sum_score ("reconstruction") inputs: over domains
     * with envsc - domcorrection > 0: sum of envsc (nats), sum of
     * domcorrection (nats), and total envelope length Ld. */
    double sum_env_nats = 0.0;
    double sum_bias_nats = 0.0;
    int ld = 0;
    std::vector<double> n2sc;
};

/* null2 by expectation over envelope [i..j] (1-based) using the
 * isolated unihit decode with length model Lseq (rescore semantics for
 * the hmmsearch path: om stays ReconfigUnihit(L_seq)). */
/* Isolated unihit Forward on a subsequence (p7_domaindef.c
 * rescore_isolated_domain's p7_Forward call: om stays configured
 * unihit with the FULL sequence length model). Fills *f and returns
 * the envelope score in nats (the binary's raw `envsc` output;
 * p7_pipeline.c reads dcl[d].envsc uncorrected). */
static double unihit_forward(const Model &m, const int32_t *sub, int Ld,
                             Fwd *fp) {
    /* Stores the M and I rows (posterior/expectation consumers); the D
     * rows are rolled through two scratch buffers — no caller reads
     * them after the sweep. */
    Fwd &f = *fp;
    int M = m.M;
    f.alloc_rows(Ld, M, /*with_d=*/false);
    f.N[0] = 1.0; f.B[0] = m.move;
    std::vector<double> dbuf0(M + 1, 0.0), dbuf1(M + 1, 0.0);
    for (int i = 1; i <= Ld; i++) {
        const double *pm = f.rowM(i - 1);
        const double *pi = f.rowI(i - 1);
        double *pd = (i & 1) ? dbuf0.data() : dbuf1.data();
        double *cm = f.rowM(i);
        double *ci = f.rowI(i);
        double *cd = (i & 1) ? dbuf1.data() : dbuf0.data();
        int x = sub[i - 1];
        const double *ex = &m.emX[(size_t)x * (M + 1)];
        double Bprev = f.B[i - 1];
        cm[0] = 0.0;
        double esum = row_fwd_m(pm, pi, pd, m.mm.data(), m.im.data(),
                                m.dm.data(), m.bmo.data(), ex, Bprev,
                                cm, M);
        row_fwd_i(pm, pi, m.mi.data(), m.ii.data(), ci, M);
        cd[0] = cd[1] = 0.0;
        for (int k = 2; k <= M; k++) {
            cd[k] = cm[k - 1] * m.md[k - 1] + cd[k - 1] * m.dd[k - 1];
            esum += cd[k];
        }
        f.E[i] = esum;
        f.C[i] = f.C[i - 1] * m.loop + esum;      /* E->C move = 1 */
        f.N[i] = f.N[i - 1] * m.loop;
        f.B[i] = f.N[i] * m.move;                 /* no J in unihit */
        f.scale_log[i] = f.scale_log[i - 1];
        {
            double rs = esum > 0.0 ? esum : f.C[i];
            if (rs > 0.0 && (rs > 1e3 || rs < 1e-3)) {
                double inv = 1.0 / rs;
                row_scale(cm, inv, M);
                row_scale(ci, inv, M);
                row_scale(cd, inv, M);
                f.E[i]*=inv; f.C[i]*=inv; f.N[i]*=inv; f.B[i]*=inv;
                f.scale_log[i] += std::log(rs);
            }
        }
    }
    return std::log(std::max(f.C[Ld], 1e-300)) + std::log(m.move)
         + f.scale_log[Ld];
}

/* Score-only unihit Forward: every row rolled, no matrix storage — the
 * per-envelope isolated rescore (rescore_isolated_domain semantics)
 * needs only the final nats. Identical recurrence/rescale order to
 * unihit_forward. */
static double unihit_forward_score(const Model &m, const int32_t *sub,
                                   int Ld) {
    int M = m.M;
    std::vector<double> mbuf0(M + 1, 0.0), mbuf1(M + 1, 0.0);
    std::vector<double> ibuf0(M + 1, 0.0), ibuf1(M + 1, 0.0);
    std::vector<double> dbuf0(M + 1, 0.0), dbuf1(M + 1, 0.0);
    double Nv = 1.0, Bv = m.move, Cv = 0.0, sl = 0.0;
    for (int i = 1; i <= Ld; i++) {
        const double *pm = (i & 1) ? mbuf0.data() : mbuf1.data();
        const double *pi = (i & 1) ? ibuf0.data() : ibuf1.data();
        const double *pd = (i & 1) ? dbuf0.data() : dbuf1.data();
        double *cm = (i & 1) ? mbuf1.data() : mbuf0.data();
        double *ci = (i & 1) ? ibuf1.data() : ibuf0.data();
        double *cd = (i & 1) ? dbuf1.data() : dbuf0.data();
        int x = sub[i - 1];
        const double *ex = &m.emX[(size_t)x * (M + 1)];
        cm[0] = 0.0;
        double esum = row_fwd_m(pm, pi, pd, m.mm.data(), m.im.data(),
                                m.dm.data(), m.bmo.data(), ex, Bv,
                                cm, M);
        row_fwd_i(pm, pi, m.mi.data(), m.ii.data(), ci, M);
        cd[0] = cd[1] = 0.0;
        for (int k = 2; k <= M; k++) {
            cd[k] = cm[k - 1] * m.md[k - 1] + cd[k - 1] * m.dd[k - 1];
            esum += cd[k];
        }
        Cv = Cv * m.loop + esum;
        Nv = Nv * m.loop;
        Bv = Nv * m.move;
        double rs = esum > 0.0 ? esum : Cv;
        if (rs > 0.0 && (rs > 1e3 || rs < 1e-3)) {
            double inv = 1.0 / rs;
            row_scale(cm, inv, M);
            row_scale(ci, inv, M);
            row_scale(cd, inv, M);
            Cv *= inv; Nv *= inv; Bv *= inv;
            sl += std::log(rs);
        }
    }
    return std::log(std::max(Cv, 1e-300)) + std::log(m.move) + sl;
}

static void null2_expectation(const Model &m_in, const int32_t *codes,
                              int Lfull, int ei, int ej,
                              std::vector<double> *n2sc,
                              double *envsc_out) {
    Model m = m_in;                     /* copy; cheap (vectors shared? no
                                           -- vectors copy; fine, reuse) */
    m.set_length(Lfull, false);         /* unihit, L = full sequence */
    int Ld = ej - ei + 1;
    const int32_t *sub = codes + (ei - 1);
    int M = m.M;
    /* unihit forward on the envelope subsequence */
    Fwd f;
    double envsc = unihit_forward(m, sub, Ld, &f);
    if (envsc_out) *envsc_out = envsc;
    /* Fused rolling backward + state-usage expectation: the backward
     * rows are consumed the moment they are produced, so no backward
     * matrix is ever stored. The posterior normalizer is the forward
     * total (envsc); the backward total equals it up to rounding. */
    double tot_log = envsc;
    std::vector<double> useM(M + 1, 0.0);
    double useI = 0.0, usetot = 0.0;
    std::vector<double> bm0(M + 1, 0.0), bm1(M + 1, 0.0),
        bi0(M + 1, 0.0), bi1(M + 1, 0.0), Dk(M + 1, 0.0);

    auto accum_row = [&](int i, const double *bm_, const double *bi_,
                         double sl_i) {
        double sc = std::exp(f.scale_log[i] + sl_i - tot_log);
        const double *fm = f.rowM(i);
        const double *fi = f.rowI(i);
        int k = 1;
#ifdef WT_ROWS_AVX512
        __m512d vsc = _mm512_set1_pd(sc);
        __m512d accM = _mm512_setzero_pd(), accI = _mm512_setzero_pd();
        for (; k + 7 <= M; k += 8) {
            __m512d pp = _mm512_mul_pd(
                _mm512_mul_pd(_mm512_loadu_pd(fm + k),
                              _mm512_loadu_pd(bm_ + k)), vsc);
            _mm512_storeu_pd(&useM[k],
                             _mm512_add_pd(_mm512_loadu_pd(&useM[k]), pp));
            accM = _mm512_add_pd(accM, pp);
            __m512d ppi = _mm512_mul_pd(
                _mm512_mul_pd(_mm512_loadu_pd(fi + k),
                              _mm512_loadu_pd(bi_ + k)), vsc);
            accI = _mm512_add_pd(accI, ppi);
        }
        double sM = _mm512_reduce_add_pd(accM);
        double sI = _mm512_reduce_add_pd(accI);
        usetot += sM + sI;
        useI += sI;
#endif
        for (; k <= M; k++) {
            double pp = fm[k] * bm_[k] * sc;
            useM[k] += pp;
            usetot += pp;
            double ppi = fi[k] * bi_[k] * sc;
            useI += ppi;
            usetot += ppi;
        }
    };

    /* row Ld boundary */
    double bN = 0.0, bC = m.move, bE = bC, sl = 0.0;
    {
        Dk[M] = bE;
        for (int k = M - 1; k >= 1; k--)
            Dk[k] = Dk[k + 1] * m.dd[k] + bE;
        double *bm_ = bm1.data();
        bm_[0] = 0.0;
        for (int k = 1; k <= M; k++)
            bm_[k] = bE + (k < M ? Dk[k + 1] * m.md[k] : 0.0);
        /* bi row Ld is all zero (bi1 initialized zero) */
        if (Ld >= 1) accum_row(Ld, bm_, bi1.data(), sl);
    }
    for (int i = Ld - 1; i >= 0; i--) {
        const double *Mn = ((Ld - i) & 1) ? bm1.data() : bm0.data();
        const double *In = ((Ld - i) & 1) ? bi1.data() : bi0.data();
        double *bm_ = ((Ld - i) & 1) ? bm0.data() : bm1.data();
        double *bi_ = ((Ld - i) & 1) ? bi0.data() : bi1.data();
        int x = sub[i];
        const double *ex = &m.emX[(size_t)x * (M + 1)];
        double Bv = row_dot3(m.bmo.data(), ex, Mn, M);
        bN = bN * m.loop + Bv * m.move;
        bC = bC * m.loop;
        bE = bC;                                /* E->C move = 1 */
        row_bck_dchain(Mn, ex, m.dm.data(), m.dd.data(), bE,
                       Dk.data(), M);
        double mx = row_bck_mi(Mn, In, ex, m.mm.data(), m.mi.data(),
                               m.md.data(), m.im.data(), m.ii.data(),
                               Dk.data(), bE, bm_, bi_, M);
        if (mx > 0.0 && (mx > 1e3 || mx < 1e-3)) {
            double inv = 1.0 / mx;
            row_scale(bm_, inv, M);
            row_scale(bi_, inv, M);
            bN *= inv; bC *= inv; bE *= inv;
            row_scale(Dk.data(), inv, M);
            sl += std::log(mx);
        }
        if (i >= 1) accum_row(i, bm_, bi_, sl);
    }
    double xocc = (double)Ld - usetot;
    if (xocc < 0.0) xocc = 0.0;
    /* null2 odds per alphabet letter (emX rows are contiguous per x) */
    std::vector<double> n2(m_in.K, 0.0);
    for (int x = 0; x < m_in.K; x++) {
        const double *exr = &m_in.emX[(size_t)x * (M + 1)];
        double v = useI + xocc;
        int k = 1;
#ifdef WT_ROWS_AVX512
        __m512d acc = _mm512_setzero_pd();
        for (; k + 7 <= M; k += 8)
            acc = _mm512_fmadd_pd(_mm512_loadu_pd(&useM[k]),
                                  _mm512_loadu_pd(exr + k), acc);
        v += _mm512_reduce_add_pd(acc);
#endif
        for (; k <= M; k++)
            v += useM[k] * exr[k];
        n2[x] = v / (double)Ld;
    }
    for (int pos = ei; pos <= ej; pos++) {
        double v = n2[codes[pos - 1]];
        (*n2sc)[pos] = std::log(std::max(v, 1e-30));
    }
}

/* Post-rows evaluation: regions + ensembles + null2 from flank
 * posterior rows (mocc/dB/dE, conventions of evaluate_target below).
 * `mo` must already be length-configured (multihit); `mo_in` is the
 * raw model (the isolated-envelope rescore reconfigures it unihit).
 * Does NOT touch res->fwd_nats. */
static void evaluate_target_rows(const Model &mo_in, const Model &mo,
                                 const int32_t *codes, int L,
                                 uint32_t seed, int nsamples,
                                 bool want_null2,
                                 const std::vector<double> &mocc,
                                 const std::vector<double> &dB,
                                 const std::vector<double> &dE,
                                 TargetResult *res) {
    std::vector<Region> regions = find_regions_c(mocc, dB, dE, L);
    res->nregions = (int)regions.size();
    res->nenvelopes = 0;
    if (want_null2) res->n2sc.assign(L + 1, 0.0);
    if (regions.empty()) return;
    /* cumulative B/E mass for the multidomain split test */
    std::vector<double> btot(L + 1, 0.0), etot(L + 1, 0.0);
    for (int i = 1; i <= L; i++) {
        btot[i] = btot[i - 1] + dB[i];
        etot[i] = etot[i - 1] + dE[i];
    }
    for (const Region &rg : regions) {
        float best = 0.0f;
        for (int z = rg.i; z <= rg.j; z++) {
            float epre = (float)(etot[z] - etot[rg.i - 1]);
            float bpost = (float)(btot[rg.j] - btot[z - 1]);
            float v = epre < bpost ? epre : bpost;
            if (v > best) best = v;
        }
        if (best < 0.20f) {
            /* deterministic single envelope = the region */
            res->nenvelopes += 1;
            if (want_null2) {
                double envsc = 0.0;
                null2_expectation(mo_in, codes, L, rg.i, rg.j,
                                  &res->n2sc, &envsc);
                double domcorr = 0.0;
                for (int p = rg.i; p <= rg.j; p++)
                    domcorr += res->n2sc[p];
                if (envsc - domcorr > 0.0) {
                    res->sum_env_nats += envsc;
                    res->sum_bias_nats += domcorr;
                    res->ld += rg.j - rg.i + 1;
                }
            }
            continue;
        }
        /* multidomain: re-seeded trace ensemble on the region.  When
         * the alphabet tables are set, sample from the exact-f32
         * striped Forward (the binary's own value stream); the f64
         * engine remains as fallback. */
        int Ld = rg.j - rg.i + 1;
        bool use32 = (bool)mo.oprof;
        Fwd rf;
        stoch32::Fwd32 rf32;
        stoch32::XF xf32;
        if (use32) {
            stoch32::xf_set(&xf32, L, mo.oprof->nj);
            stoch32::forward_f32(*mo.oprof, xf32, codes + (rg.i - 1),
                                 Ld, &rf32);
        } else {
            forward_region(mo, codes + (rg.i - 1), Ld, &rf);
        }
        EselRng rng(seed);
        std::vector<Seg> segs;
        std::vector<double> n2acc;
        if (want_null2) n2acc.assign(Ld + 1, 0.0);
        std::vector<TraceStep> steps;
        std::vector<Seg> tsegs;
        for (int t = 0; t < nsamples; t++) {
            tsegs.clear(); steps.clear();
            if (use32)
                stoch32::sample_trace_f32(rng, *mo.oprof, xf32, rf32, t,
                                          &tsegs,
                                          want_null2 ? &steps : nullptr);
            else
                sample_trace(rng, mo, rf, t, &tsegs,
                             want_null2 ? &steps : nullptr);
            for (auto &sgm : tsegs) segs.push_back(sgm);
            if (want_null2) {
                std::vector<char> cov(Ld + 1, 0);
                for (auto &sgm : tsegs) {
                    double total = 0.0;
                    std::vector<int> kc;
                    int n_ins = 0;
                    for (auto &stp : steps) {
                        if (stp.i < sgm.i || stp.i > sgm.j) continue;
                        total += 1.0;
                        if (stp.st == 'M') kc.push_back(stp.k);
                        else n_ins++;
                    }
                    if (total <= 0.0) continue;
                    for (int pos = sgm.i; pos <= sgm.j; pos++) {
                        int x = codes[rg.i - 1 + pos - 1];
                        double num = (double)n_ins;
                        for (int kk : kc)
                            num += mo.em[(size_t)kk * mo.K + x];
                        n2acc[pos] += num / total;
                        cov[pos] = 1;
                    }
                }
                for (int pos = 1; pos <= Ld; pos++)
                    if (!cov[pos]) n2acc[pos] += 1.0;
            }
        }
        std::vector<Cluster> cls = cluster_segments(segs, nsamples);
        res->nenvelopes += (int)cls.size();
        if (want_null2) {
            for (int pos = 1; pos <= Ld; pos++) {
                float v = (float)(n2acc[pos] / (double)nsamples);
                res->n2sc[rg.i + pos - 1] =
                    (double)std::log(std::max(v, 1e-30f));
            }
            /* per-envelope rescore for the reconstruction score
             * (rescore_isolated_domain with null2_is_done: envsc =
             * isolated unihit Forward, domcorrection = sum of the
             * ByTrace n2sc over the envelope) */
            Model miso = mo_in;
            miso.set_length(L, false);
            for (const Cluster &c : cls) {
                int ie = rg.i + c.i - 1, je = rg.i + c.j - 1;
                double envsc = unihit_forward_score(miso, codes + (ie - 1),
                                                    je - ie + 1);
                double domcorr = 0.0;
                for (int p = ie; p <= je; p++)
                    domcorr += res->n2sc[p];
                if (envsc - domcorr > 0.0) {
                    res->sum_env_nats += envsc;
                    res->sum_bias_nats += domcorr;
                    res->ld += je - ie + 1;
                }
            }
        }
    }
    if (want_null2) {
        double s = 0.0;
        for (int i = 1; i <= L; i++) s += res->n2sc[i];
        double lw = std::log(1.0 / 256.0) + s;
        /* FLogsum(0, lw) */
        res->seqbias_nats = lw > 0.0
            ? lw + std::log1p(std::exp(-lw))
            : std::log1p(std::exp(lw));
    }
}

/* ---- exact-f32 reported-score chain (p7_pipeline.c semantics) ------- */

/* esl_vec_FSum over n floats, 16-aligned base: two 4-lane f32
 * accumulators interleaved by 8, reduce (a0+a2)+(a1+a3), scalar tail
 * (exact emulation of the compiled vectorized sum). */
static float fsum_f32(const float *p, int n) {
    if (n < 8) {
        float s = 0.0f;
        for (int i = 0; i < n; i++) s += p[i];
        return s;
    }
    int nb = n & ~7;
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < nb; i += 8) {
        for (int z = 0; z < 4; z++) a0[z] += p[i + z];
        for (int z = 0; z < 4; z++) a1[z] += p[i + 4 + z];
    }
    for (int z = 0; z < 4; z++) a0[z] += a1[z];
    float t0 = a0[0] + a0[2];
    float t1 = a0[1] + a0[3];
    float s = t0 + t1;
    for (int i = nb; i < n; i++) s += p[i];
    return s;
}

/* esl_abc_FAvgScVec's tail of the f32 null2 chains: a degeneracy is the
 * unweighted f32 mean of its members' values, the gap code 1.0 */
static void null2_degenerate_f32(float *null2) {
    int Kc = g_alpha_kc;
    for (int c = Kc + 1; c < g_alpha_ncodes; c++) {
        float s = 0.0f;
        int n = 0;
        for (int y = 0; y < Kc; y++)
            if (g_alpha_expand[(size_t)c * Kc + y] > 0.0) {
                s += null2[y];
                n++;
            }
        null2[c] = s / (float)n;
    }
    null2[Kc] = 1.0f;
}

/* p7_Null2_ByTrace, exact f32: M and I emissions of the domain's trace
 * positions lump into one striped count plane (the binary's own
 * behavior), normalized by 1/(float)Ld; null2[x] = striped dot with
 * rfv + xfactor; degeneracies via FAvgScVec. */
static void null2_by_trace_f32(const stoch32::OProfile &om,
                               const std::vector<TraceStep> &steps,
                               int si, int sj, float *null2) {
    int Q = om.Q;
    std::vector<float> counts((size_t)Q * 4, 0.0f);
    float Ld = 0.0f;
    int ld_i = 0;
    for (const TraceStep &st : steps) {
        if (st.i < si || st.i > sj) continue;
        if (st.k > 0) {
            int q = (st.k - 1) % Q, r = (st.k - 1) / Q;
            counts[(size_t)q * 4 + r] += 1.0f;
            ld_i++;
        }
    }
    Ld = (float)ld_i;
    float inv = 1.0f / Ld;
    for (size_t n = 0; n < counts.size(); n++) counts[n] *= inv;
    float xfactor = 0.0f;
    int Kc = g_alpha_kc;
    for (int x = 0; x < Kc; x++) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float *rp = om.rf(x);
        for (int q = 0; q < Q; q++)
            for (int z = 0; z < 4; z++)
                acc[z] = acc[z] + counts[(size_t)q * 4 + z] * rp[q * 4 + z];
        float b0 = acc[0] + acc[1];
        float b2 = acc[2] + acc[3];
        null2[x] = (b0 + b2) + xfactor;
    }
    null2_degenerate_f32(null2);
}

/* rescore_isolated_domain's scoring half, exact f32: unihit
 * Forward/Backward/Decoding on the envelope, Null2_ByExpectation,
 * n2sc fill with icc logf, domcorrection f32 sum.  Returns false on
 * the binary's eslERANGE rejection. */
static bool rescore_isolated_f32(const Model &mo, const int32_t *codes,
                                 int Lseq, int i, int j,
                                 std::vector<float> &n2sc,
                                 float *envsc_out, float *domcorr_out) {
    const stoch32::OProfile &om = *mo.oprof;
    int Ld = j - i + 1;
    stoch32::XF xfu;
    stoch32::xf_set_unihit(&xfu, Lseq);
    static thread_local stoch32::Fwd32 f, b, pp;
    stoch32::forward_f32(om, xfu, codes + (i - 1), Ld, &f);
    stoch32::backward_f32(om, xfu, codes + (i - 1), Ld, f, &b);
    if (!stoch32::decoding_f32(om, xfu, f, b, &pp))
        return false;
    std::vector<float> null2(om.ncodes, 0.0f);
    stoch32::null2_by_expectation_f32(om, xfu, &pp,
                                      g_alpha_expand.data(), g_alpha_kc,
                                      null2.data());
    float domcorr = 0.0f;
    for (int pos = i; pos <= j; pos++) {
        float v = stoch32::x_logf(null2[codes[pos - 1]]);
        n2sc[pos] = v;
    }
    for (int pos = i; pos <= j; pos++) domcorr += n2sc[pos];
    *envsc_out = f.fwdsc;
    *domcorr_out = domcorr;
    return true;
}

/* One domain of the score assembly: its envelope score and null2
 * correction (nats) and its envelope. */
struct Dom32 { float envsc, domcorr; int ienv, jenv; };
struct Exact32Dbg;
static void assemble32(float fwdsc, int L, const std::vector<float> &n2sc,
                       const std::vector<Dom32> &doms, double *seq_bits,
                       double *pre_bits, Exact32Dbg *dbg);

/* Exact-f32 reported score for one (model, target) pair, single-
 * envelope regions only (multidomain regions return false -> caller
 * keeps the f64 path).  Mirrors p7_pipeline.c's post-domaindef score
 * assembly: seqbias via the flogsum table, reconstruction-score
 * substitution, all f32 with double divisions by eslCONST_LOG2. */
struct Exact32Dbg {
    float fwdsc = 0, nullsc = 0, seqbias = 0, sum_score = 0,
          seqbias2 = 0;
    std::vector<float> n2sc;
    std::vector<float> envsc, domcorr;
};
static Exact32Dbg *g_x32_dbg = nullptr;

static bool exact32_target(const Model &mo, const int32_t *codes, int L,
                           double *seq_bits, double *pre_bits) {
    if (!mo.oprof || g_alpha_kc == 0) return false;
    const stoch32::OProfile &omf = *mo.oprof;
    stoch32::XF xff;
    stoch32::xf_set(&xff, L, omf.nj);
    /* full-sequence F+B: only the xmx specials are consumed below
     * (domain decoding + fwdsc), so stream with a 2-row dp window —
     * identical value stream, ~50 MB less traffic per pair */
    static thread_local stoch32::Fwd32 f32full, b32full;
    stoch32::forward_f32(omf, xff, codes, L, &f32full, true);
    stoch32::backward_f32(omf, xff, codes, L, f32full, &b32full, true);
    std::vector<float> mocc32(L + 1), btot(L + 1), etot(L + 1);
    if (!stoch32::domain_decoding_f32(xff, f32full, b32full,
                                      mocc32.data(), btot.data(),
                                      etot.data()))
        return false;
    /* region scan on the binary's own f32 posterior rows with its
     * cumulative-difference test (f64 rows and fresh-posterior
     * differences both flip knife-edge region boundaries) */
    std::vector<Region> regions = find_regions_f32(
        mocc32.data(), btot.data(), etot.data(), L);
    if (regions.empty()) return false;
    std::vector<Dom32> doms;
    std::vector<float> n2sc(L + 1, 0.0f);
    for (const Region &rg : regions) {
        float best = 0.0f;
        for (int z = rg.i; z <= rg.j; z++) {
            float epre = etot[z] - etot[rg.i - 1];
            float bpost = btot[rg.j] - btot[z - 1];
            float v = epre < bpost ? epre : bpost;
            if (v > best) best = v;
        }
        if (best < 0.20f) {
            float envsc, domcorr;
            if (!rescore_isolated_f32(mo, codes, L, rg.i, rg.j, n2sc,
                                      &envsc, &domcorr))
                return false;
            doms.push_back({envsc, domcorr, rg.i, rg.j});
            continue;
        }
        /* multidomain region: exact-f32 trace ensemble + ByTrace n2sc
         * with the binary's interleaved 1.0 gap fill, then cluster
         * envelopes rescored (null2 already done) */
        int Ldr = rg.j - rg.i + 1;
        const stoch32::OProfile &omr = *mo.oprof;
        stoch32::XF xfm2;
        stoch32::xf_set(&xfm2, L, omr.nj);
        static thread_local stoch32::Fwd32 rf32;
        stoch32::forward_f32(omr, xfm2, codes + (rg.i - 1), Ldr, &rf32);
        EselRng rng(42);
        std::vector<Seg> segs_all;
        std::vector<Seg> tsegs;
        std::vector<TraceStep> steps;
        std::vector<float> null2v(omr.ncodes, 0.0f);
        const int NS = 200;
        for (int t = 0; t < NS; t++) {
            tsegs.clear();
            steps.clear();
            stoch32::sample_trace_f32(rng, omr, xfm2, rf32, t, &tsegs,
                                      &steps);
            std::reverse(tsegs.begin(), tsegs.end());
            int cursor = 1;
            for (const Seg &sg : tsegs) {
                /* the binary's gap fill (hmmsearch 0x44976d-0x4497b5)
                 * runs [cursor .. sqfrom] INCLUSIVE of the segment's
                 * first position; null2 covers only [sqfrom+1..sqto] */
                if (cursor <= sg.i) {
                    for (int pos = cursor; pos <= sg.i && pos <= Ldr;
                         pos++)
                        n2sc[rg.i - 1 + pos] += 1.0f;
                    cursor = sg.i + 1;
                }
                null2_by_trace_f32(omr, steps, sg.i, sg.j,
                                   null2v.data());
                if (cursor <= sg.j) {
                    for (int pos = cursor; pos <= sg.j; pos++)
                        n2sc[rg.i - 1 + pos] +=
                            null2v[codes[rg.i - 1 + pos - 1]];
                    cursor = sg.j + 1;
                }
                segs_all.push_back(sg);
            }
            for (int pos = cursor; pos <= Ldr; pos++)
                n2sc[rg.i - 1 + pos] += 1.0f;
        }
        for (int pos = rg.i; pos <= rg.j; pos++)
            n2sc[pos] = stoch32::x_logf(n2sc[pos] / (float)NS);
        std::vector<Cluster> cls = cluster_segments(segs_all, NS);
        std::sort(cls.begin(), cls.end(),
                  [](const Cluster &a, const Cluster &b) {
                      return a.i < b.i;
                  });
        for (const Cluster &c : cls) {
            int ie = rg.i + c.i - 1, je = rg.i + c.j - 1;
            stoch32::XF xfu;
            stoch32::xf_set_unihit(&xfu, L);
            static thread_local stoch32::Fwd32 fe;
            /* only fe.fwdsc is consumed: stream */
            stoch32::forward_f32(omr, xfu, codes + (ie - 1),
                                 je - ie + 1, &fe, true);
            float domcorr = 0.0f;
            for (int pos = ie; pos <= je; pos++) domcorr += n2sc[pos];
            doms.push_back({fe.fwdsc, domcorr, ie, je});
        }
    }
    /* full-sequence multihit parser score (from the pass above) */
    assemble32(f32full.fwdsc, L, n2sc, doms, seq_bits, pre_bits, g_x32_dbg);
    return true;
}

/* p7_pipeline.c's post-domaindef score assembly from the full-sequence
 * Forward score, the per-position null2 scores n2sc [L+1] and the
 * domains: seqbias via the flogsum table, reconstruction-score
 * substitution, all f32 with double divisions by eslCONST_LOG2. */
static void assemble32(float fwdsc, int L, const std::vector<float> &n2sc,
                       const std::vector<Dom32> &doms, double *seq_bits,
                       double *pre_bits, Exact32Dbg *dbg) {
    float nullsc = stoch32::null1_f32(L);
    double lomega = stoch32::x_log(1.0 / 256.0);
    float seqbias = fsum_f32(n2sc.data(), L + 1);
    seqbias = stoch32::p7_flogsum(0.0f, (float)(lomega + (double)seqbias));
    float pre_score = (float)(((double)(fwdsc - nullsc)) /
                              0.69314718055994529);
    float seq_score = (float)(((double)(fwdsc - (nullsc + seqbias))) /
                              0.69314718055994529);
    float sum_score = 0.0f;
    float seqbias2 = 0.0f;
    int Ld = 0;
    for (const Dom32 &d : doms) {
        if (d.envsc - d.domcorr > 0.0f) {
            sum_score += d.envsc;
            Ld += d.jenv - d.ienv + 1;
            seqbias2 += d.domcorr;
        }
    }
    seqbias2 = stoch32::p7_flogsum(0.0f,
                                   (float)(lomega + (double)seqbias2));
    /* sum_score += (n - Ld) * log((float)n/(float)(n+3)): the += is a
     * double add rounded once to f32 */
    sum_score = (float)((double)sum_score +
                        (double)(L - Ld) *
                            stoch32::x_log((double)((float)L /
                                                    (float)(L + 3))));
    float pre2 = (float)(((double)(sum_score - nullsc)) /
                         0.69314718055994529);
    float sum2 = (float)(((double)(sum_score - (nullsc + seqbias2))) /
                         0.69314718055994529);
    if (dbg) {
        dbg->fwdsc = fwdsc;
        dbg->nullsc = nullsc;
        dbg->seqbias = seqbias;
        dbg->sum_score = sum_score;
        dbg->seqbias2 = seqbias2;
        dbg->n2sc = n2sc;
        for (const Dom32 &d : doms) {
            dbg->envsc.push_back(d.envsc);
            dbg->domcorr.push_back(d.domcorr);
        }
    }
    if (Ld > 0 && sum2 > seq_score) { seq_score = sum2; pre_score = pre2; }
    *seq_bits = (double)seq_score;
    *pre_bits = (double)pre_score;
}

static void evaluate_target(const Model &mo_in, const int32_t *codes,
                            int L, uint32_t seed, int nsamples,
                            bool want_null2, TargetResult *res) {
    Model mo = mo_in;
    mo.set_length(L, true);
    Fwd f;
    forward_region(mo, codes, L, &f);   /* full-seq multihit forward */
    Bck b;
    backward_full(mo, codes, L, &b);
    double tot_log = std::log(std::max(b.N[0], 1e-300)) + b.scale_log[0];
    res->fwd_nats = std::log(std::max(f.C[L], 1e-300)) + std::log(mo.move)
                  + f.scale_log[L];
    /* flank posteriors -> mocc, dB, dE */
    std::vector<double> mocc(L + 1, 0.0), dB(L + 1, 0.0), dE(L + 1, 0.0);
    for (int i = 1; i <= L; i++) {
        double sc_im1_i = std::exp(f.scale_log[i - 1] + b.scale_log[i]
                                   - tot_log);
        double ppN = f.N[i - 1] * mo.loop * b.N[i] * sc_im1_i;
        double ppJ = f.J[i - 1] * mo.loop * b.J[i] * sc_im1_i;
        double ppC = f.C[i - 1] * mo.loop * b.C[i] * sc_im1_i;
        double flank = ppN + ppJ + ppC;
        mocc[i] = 1.0 - flank;
        double sc_i = std::exp(f.scale_log[i] + b.scale_log[i] - tot_log);
        double sc_im1 = std::exp(f.scale_log[i - 1] + b.scale_log[i - 1]
                                 - tot_log);
        dB[i] = f.B[i - 1] * b.B[i - 1] * sc_im1;   /* B at row i-1 */
        dE[i] = f.E[i] * b.E[i] * sc_i;             /* E at row i */
    }
    evaluate_target_rows(mo_in, mo, codes, L, seed, nsamples,
                         want_null2, mocc, dB, dE, res);
}

/* ---------------- python glue --------------------------------------- */

static bool get1d_f64(PyObject *o, const double **p, npy_intp *n) {
    PyArrayObject *a = (PyArrayObject *)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_FLOAT64 ||
        PyArray_NDIM(a) != 1 || !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_TypeError, "expected float64 1D array");
        return false;
    }
    *p = (const double *)PyArray_DATA(a);
    *n = PyArray_DIM(a, 0);
    return true;
}

/* ensemble_region(msc2d, tmm, tmi, tmd, tim, tii, tdm, tdd, bm,
 *                 codes_i32, Lseq, seed, nsamples, want_null2)
 * -> (clusters list, n2acc or None)
 * n2acc: float64 [L+1]; n2acc[pos]/nsamples is the expected null2 odds
 * at region position pos (1-based), background 1.0 where uncovered. */
static PyObject *ensemble_region(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    int Lseq, seed, nsamples, want_null2;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOiiii", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lseq, &seed,
                          &nsamples, &want_null2))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    if (!PyArray_Check(omsc) || PyArray_TYPE(amsc) != NPY_FLOAT64 ||
        PyArray_NDIM(amsc) != 2 || !PyArray_IS_C_CONTIGUOUS(amsc)) {
        PyErr_SetString(PyExc_TypeError, "msc must be f64 2D");
        return NULL;
    }
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
        if (tn != mo.M + 1) {
            PyErr_SetString(PyExc_ValueError, "transition length != M+1");
            return NULL;
        }
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];

    PyArrayObject *ac = (PyArrayObject *)ocodes;
    if (!PyArray_Check(ocodes) || PyArray_TYPE(ac) != NPY_INT32 ||
        PyArray_NDIM(ac) != 1 || !PyArray_IS_C_CONTIGUOUS(ac)) {
        PyErr_SetString(PyExc_TypeError, "codes must be i32 1D");
        return NULL;
    }
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    for (int i = 0; i < L; i++) {
        if (codes[i] < 0 || codes[i] >= mo.K) {
            PyErr_SetString(PyExc_ValueError, "residue code out of range");
            return NULL;
        }
    }

    std::vector<Seg> segs;
    std::vector<double> n2acc;
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(Lseq);
        mo.build_oprof();
        bool use32 = (bool)mo.oprof;
        Fwd f;
        stoch32::Fwd32 f32;
        stoch32::XF xf32;
        if (use32) {
            stoch32::xf_set(&xf32, Lseq, mo.oprof->nj);
            stoch32::forward_f32(*mo.oprof, xf32, codes, L, &f32);
        } else {
            forward_region(mo, codes, L, &f);
        }
        EselRng rng((uint32_t)seed);
        if (want_null2) n2acc.assign(L + 1, 0.0);
        std::vector<TraceStep> steps;
        std::vector<Seg> tsegs;
        for (int t = 0; t < nsamples; t++) {
            tsegs.clear();
            steps.clear();
            if (use32)
                stoch32::sample_trace_f32(rng, *mo.oprof, xf32, f32, t,
                                          &tsegs,
                                          want_null2 ? &steps : nullptr);
            else
                sample_trace(rng, mo, f, t,
                             &tsegs, want_null2 ? &steps : nullptr);
            /* domains were collected in reverse (trace walks backwards);
               order within the sample does not matter for clustering */
            for (auto &s : tsegs) segs.push_back(s);
            if (want_null2) {
                /* per-sample null2: match emissions use the state's
                   odds row; insert emissions odds 1; positions outside
                   all domains odds 1 (p7_Null2_ByTrace + gap fill) */
                std::vector<char> cov(L + 1, 0);
                for (auto &s : tsegs) {
                    /* per-domain expectation over its trace states */
                    double total = 0.0;
                    std::vector<std::pair<int,int>> memits; /* (k, i) */
                    int n_ins = 0;
                    for (auto &stp : steps) {
                        if (stp.i < s.i || stp.i > s.j) continue;
                        total += 1.0;
                        if (stp.st == 'M') memits.push_back({stp.k, stp.i});
                        else n_ins++;
                    }
                    if (total <= 0.0) continue;
                    /* null2 odds for residue x: (sum_k cnt_k*odds_k(x) +
                       n_ins) / total; evaluate per covered position */
                    for (int pos = s.i; pos <= s.j; pos++) {
                        int x = codes[pos - 1];
                        double num = (double)n_ins;
                        for (auto &me : memits)
                            num += mo.em[(size_t)me.first * mo.K + x];
                        n2acc[pos] += num / total;
                        cov[pos] = 1;
                    }
                }
                for (int pos = 1; pos <= L; pos++)
                    if (!cov[pos]) n2acc[pos] += 1.0;
            }
        }
        Py_END_ALLOW_THREADS
    }
    std::vector<Cluster> clusters = cluster_segments(segs, nsamples);

    PyObject *clist = PyList_New((Py_ssize_t)clusters.size());
    if (!clist) return NULL;
    for (size_t ci = 0; ci < clusters.size(); ci++) {
        const Cluster &c = clusters[ci];
        PyObject *tup = Py_BuildValue("(iiiidi)", c.i, c.j, c.k, c.m,
                                      c.post, c.nsamp);
        if (!tup) { Py_DECREF(clist); return NULL; }
        PyList_SET_ITEM(clist, (Py_ssize_t)ci, tup);
    }
    PyObject *n2obj = Py_None;
    if (want_null2) {
        npy_intp dim = L + 1;
        PyArrayObject *arr = (PyArrayObject *)PyArray_SimpleNew(
            1, &dim, NPY_FLOAT64);
        if (!arr) { Py_DECREF(clist); return NULL; }
        std::memcpy(PyArray_DATA(arr), n2acc.data(),
                    sizeof(double) * (L + 1));
        n2obj = (PyObject *)arr;
    } else {
        Py_INCREF(Py_None);
    }
    PyObject *ret = PyTuple_Pack(2, clist, n2obj);
    Py_DECREF(clist);
    Py_DECREF(n2obj);
    return ret;
}


/* shared parsing for the one-model-vs-many-targets entry points */
static bool parse_model_targets(PyObject *omsc, PyObject *ot[8],
                                PyObject *olist, Model *mo,
                                std::vector<const int32_t *> *cptr,
                                std::vector<int> *clen) {
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    if (!PyArray_Check(omsc) || PyArray_TYPE(amsc) != NPY_FLOAT64 ||
        PyArray_NDIM(amsc) != 2 || !PyArray_IS_C_CONTIGUOUS(amsc)) {
        PyErr_SetString(PyExc_TypeError, "msc must be f64 2D");
        return false;
    }
    mo->M = (int)PyArray_DIM(amsc, 0) - 1;
    mo->K = (int)PyArray_DIM(amsc, 1);
    mo->msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return false;
        if (tn != mo->M + 1) {
            PyErr_SetString(PyExc_ValueError, "transition length != M+1");
            return false;
        }
    }
    mo->t_mm = tp[0]; mo->t_mi = tp[1]; mo->t_md = tp[2];
    mo->t_im = tp[3]; mo->t_ii = tp[4]; mo->t_dm = tp[5];
    mo->t_dd = tp[6]; mo->bm = tp[7];

    if (!PyList_Check(olist)) {
        PyErr_SetString(PyExc_TypeError, "codes_list must be a list");
        return false;
    }
    Py_ssize_t N = PyList_GET_SIZE(olist);
    cptr->resize(N);
    clen->resize(N);
    for (Py_ssize_t n = 0; n < N; n++) {
        PyArrayObject *ac = (PyArrayObject *)PyList_GET_ITEM(olist, n);
        if (!PyArray_Check((PyObject *)ac) ||
            PyArray_TYPE(ac) != NPY_INT32 || PyArray_NDIM(ac) != 1 ||
            !PyArray_IS_C_CONTIGUOUS(ac)) {
            PyErr_SetString(PyExc_TypeError, "codes must be i32 1D");
            return false;
        }
        (*cptr)[n] = (const int32_t *)PyArray_DATA(ac);
        (*clen)[n] = (int)PyArray_DIM(ac, 0);
        for (int i = 0; i < (*clen)[n]; i++) {
            if ((*cptr)[n][i] < 0 || (*cptr)[n][i] >= mo->K) {
                PyErr_SetString(PyExc_ValueError, "code out of range");
                return false;
            }
        }
    }
    return true;
}

/* forward_targets(msc2d, tmm..bm, codes_list, nthreads) -> f64[N]
 * Forward-only scores in nats (the same multihit full-sequence
 * Forward that evaluate_targets reports as fwd) — the cheap CPU
 * pre-ranker: ~5-10x cheaper per pair than the full domain-definition
 * evaluation, used to pick gate candidates per query the way the
 * Pallas pre-score does on TPU (pipeline.compute_scores). */
static PyObject *forward_targets(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *olist;
    int nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptr;
    std::vector<int> clen;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptr, &clen))
        return NULL;
    Py_ssize_t N = (Py_ssize_t)cptr.size();
    std::vector<double> fwd(N, 0.0);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);   /* odds tables; length set per target */
        int nt = nthreads < 1 ? 1 : nthreads;
        if (nt > 16) nt = 16;
        std::vector<std::thread> threads;
        std::atomic<Py_ssize_t> next(0);
        auto work = [&]() {
            for (;;) {
                Py_ssize_t n = next.fetch_add(1);
                if (n >= N) break;
                Model m = mo;
                m.set_length(clen[n], true);
                Fwd f;
                forward_region(m, cptr[n], clen[n], &f);
                fwd[n] = std::log(std::max(f.C[clen[n]], 1e-300))
                       + std::log(m.move) + f.scale_log[clen[n]];
            }
        };
        if (nt == 1) work();
        else {
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp dim = N;
    PyArrayObject *afwd = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    if (!afwd) return NULL;
    for (Py_ssize_t n = 0; n < N; n++)
        ((double *)PyArray_DATA(afwd))[n] = fwd[n];
    return (PyObject *)afwd;
}

/* ---------------- lane-parallel f32 Forward (AVX-512) ----------------
 *
 * forward_targets_simd: same contract as forward_targets (multihit
 * full-sequence Forward in nats, length model per target — the
 * hmmsearch pre-ranking score, reference contract
 * witch_msa/gcmm/algorithm.py:524-537), but 16 targets ride the lanes
 * of one AVX-512 vector in f32 odds space with power-of-2 per-row
 * rescaling (getexp/scalef keeps the scale ledger exact). Used only
 * for candidate RANKING — exact f64 scores for every reported pair
 * still come from evaluate_targets (pipeline.compute_scores), the same
 * split the Pallas f32 kernel uses on the accelerator. */

#ifdef __AVX512F__
#include <immintrin.h>

struct SimdTables {
    int M, K;
    std::vector<float> emX;                    /* [K][M+1] odds */
    std::vector<float> mm, mi, md, im, ii, dm, dd, bmo;
};

static void build_simd_tables(const Model &m, SimdTables *T) {
    T->M = m.M; T->K = m.K;
    T->emX.resize(m.emX.size());
    for (size_t i = 0; i < m.emX.size(); i++)
        T->emX[i] = (float)m.emX[i];
    auto cv = [](const std::vector<double> &src, std::vector<float> &dst) {
        dst.resize(src.size());
        for (size_t i = 0; i < src.size(); i++) dst[i] = (float)src[i];
    };
    cv(m.mm, T->mm); cv(m.mi, T->mi); cv(m.md, T->md);
    cv(m.im, T->im); cv(m.ii, T->ii); cv(m.dm, T->dm);
    cv(m.dd, T->dd); cv(m.bmo, T->bmo);
}

/* One group of <= 16 targets (lanes sorted ascending by length).
 * out[l] receives the Forward score in nats for lane l. */
static void forward_group16(const SimdTables &T,
                            const int32_t *const *cptr, const int *clen,
                            int nl, float *bufA, float *bufB,
                            int32_t *xoff, double *out) {
    const int M = T.M;
    const size_t row = (size_t)(M + 1) * 16;
    int Lmax = 0;
    for (int l = 0; l < nl; l++) Lmax = std::max(Lmax, clen[l]);

    alignas(64) float movef[16], loopf[16];
    double moved[16];
    for (int l = 0; l < 16; l++) {
        double pmove = l < nl ? 3.0 / ((double)clen[l] + 3.0) : 1.0;
        moved[l] = pmove;
        movef[l] = (float)pmove;
        loopf[l] = (float)(1.0 - pmove);
    }
    for (int i = 0; i < Lmax; i++)
        for (int l = 0; l < 16; l++)
            xoff[(size_t)i * 16 + l] =
                (l < nl && i < clen[l]) ? cptr[l][i] * (M + 1) : 0;

    std::memset(bufA, 0, row * 3 * sizeof(float));
    std::memset(bufB, 0, row * 3 * sizeof(float));
    float *pm = bufA, *pi = bufA + row, *pd = bufA + 2 * row;
    float *cm = bufB, *ci = bufB + row, *cd = bufB + 2 * row;

    const __m512 zero = _mm512_setzero_ps();
    const __m512 one = _mm512_set1_ps(1.0f);
    const __m512 half = _mm512_set1_ps(0.5f);
    const __m512 loopv = _mm512_load_ps(loopf);
    const __m512 movev = _mm512_load_ps(movef);
    __m512 Nv = one, Jv = zero, Cv = zero;
    __m512 Bv = movev;                         /* B[0] = move */
    __m512 etot = zero;
    int next_end = 0;                          /* lanes sorted by len */

    for (int i = 1; i <= Lmax; i++) {
        const __m512i xo =
            _mm512_loadu_si512((const void *)(xoff + (size_t)(i - 1) * 16));
        const __m512 Bprev = Bv;
        __m512 esum = zero;
        for (int k = 1; k <= M; k++) {
            __m512 src = _mm512_mul_ps(Bprev, _mm512_set1_ps(T.bmo[k]));
            src = _mm512_fmadd_ps(_mm512_loadu_ps(pm + 16 * (k - 1)),
                                  _mm512_set1_ps(T.mm[k - 1]), src);
            src = _mm512_fmadd_ps(_mm512_loadu_ps(pi + 16 * (k - 1)),
                                  _mm512_set1_ps(T.im[k - 1]), src);
            src = _mm512_fmadd_ps(_mm512_loadu_ps(pd + 16 * (k - 1)),
                                  _mm512_set1_ps(T.dm[k - 1]), src);
            const __m512i idx =
                _mm512_add_epi32(xo, _mm512_set1_epi32(k));
            const __m512 ex =
                _mm512_i32gather_ps(idx, T.emX.data(), 4);
            const __m512 v = _mm512_mul_ps(src, ex);
            _mm512_storeu_ps(cm + 16 * k, v);
            esum = _mm512_add_ps(esum, v);
            if (k < M) {
                const __m512 iv = _mm512_fmadd_ps(
                    _mm512_loadu_ps(pm + 16 * k),
                    _mm512_set1_ps(T.mi[k]),
                    _mm512_mul_ps(_mm512_loadu_ps(pi + 16 * k),
                                  _mm512_set1_ps(T.ii[k])));
                _mm512_storeu_ps(ci + 16 * k, iv);
            }
        }
        _mm512_storeu_ps(ci + 16 * M, zero);
        /* delete chain: cd[k] = cm[k-1]*md[k-1] + cd[k-1]*dd[k-1];
         * the serial dependency is one fmadd per k, the cm*md factor
         * pipelines ahead of it */
        __m512 dprev = zero;
        for (int k = 2; k <= M; k++) {
            const __m512 t =
                _mm512_mul_ps(_mm512_loadu_ps(cm + 16 * (k - 1)),
                              _mm512_set1_ps(T.md[k - 1]));
            dprev = _mm512_fmadd_ps(dprev, _mm512_set1_ps(T.dd[k - 1]), t);
            _mm512_storeu_ps(cd + 16 * k, dprev);
            esum = _mm512_add_ps(esum, dprev);
        }
        /* specials: E->{J,C} split 0.5/0.5 (multihit local) */
        Jv = _mm512_fmadd_ps(Jv, loopv, _mm512_mul_ps(esum, half));
        Cv = _mm512_fmadd_ps(Cv, loopv, _mm512_mul_ps(esum, half));
        Nv = _mm512_mul_ps(Nv, loopv);
        Bv = _mm512_mul_ps(_mm512_add_ps(Nv, Jv), movev);
        /* power-of-2 rescale when any lane drifts out of range */
        const __mmask16 gm = _mm512_cmp_ps_mask(esum, zero, _CMP_GT_OQ);
        const __m512 e = _mm512_maskz_getexp_ps(gm, esum);
        const __m512 eabs = _mm512_abs_ps(e);
        if (_mm512_reduce_max_ps(eabs) > 24.0f) {
            const __m512 sc =
                _mm512_scalef_ps(one, _mm512_sub_ps(zero, e));
            for (int k = 0; k <= M; k++) {
                _mm512_storeu_ps(cm + 16 * k, _mm512_mul_ps(
                    _mm512_loadu_ps(cm + 16 * k), sc));
                _mm512_storeu_ps(ci + 16 * k, _mm512_mul_ps(
                    _mm512_loadu_ps(ci + 16 * k), sc));
                _mm512_storeu_ps(cd + 16 * k, _mm512_mul_ps(
                    _mm512_loadu_ps(cd + 16 * k), sc));
            }
            Nv = _mm512_mul_ps(Nv, sc);
            Bv = _mm512_mul_ps(Bv, sc);
            Jv = _mm512_mul_ps(Jv, sc);
            Cv = _mm512_mul_ps(Cv, sc);
            etot = _mm512_add_ps(etot, e);
        }
        while (next_end < nl && clen[next_end] == i) {
            alignas(64) float cbuf[16], ebuf[16];
            _mm512_store_ps(cbuf, Cv);
            _mm512_store_ps(ebuf, etot);
            const int l = next_end++;
            out[l] = std::log(std::max((double)cbuf[l], 1e-300))
                   + std::log(moved[l]) + M_LN2 * (double)ebuf[l];
        }
        std::swap(pm, cm); std::swap(pi, ci); std::swap(pd, cd);
    }
    for (int l = 0; l < nl; l++)
        if (clen[l] == 0) out[l] = std::log(1e-300) + std::log(moved[l]);
}
#endif  /* __AVX512F__ */

/* forward_targets_simd(msc2d, tmm..bm, codes_list, nthreads) -> f64[N]
 * AVX-512 lane-parallel f32 pre-ranking Forward; falls back to the f64
 * scalar path when the extension was not built with AVX-512. */
static PyObject *forward_targets_simd(PyObject *self, PyObject *args) {
#ifndef __AVX512F__
    return forward_targets(self, args);
#else
    PyObject *omsc, *ot[8], *olist;
    int nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptr;
    std::vector<int> clen;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptr, &clen))
        return NULL;
    Py_ssize_t N = (Py_ssize_t)cptr.size();
    std::vector<double> fwd(N, 0.0);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);
        SimdTables T;
        build_simd_tables(mo, &T);
        /* group targets of adjacent lengths into 16-lane batches */
        std::vector<int> order(N);
        for (Py_ssize_t n = 0; n < N; n++) order[n] = (int)n;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            return clen[a] != clen[b] ? clen[a] < clen[b] : a < b;
        });
        const int ngroups = (int)((N + 15) / 16);
        int nt = nthreads < 1 ? 1 : (nthreads > 16 ? 16 : nthreads);
        if (nt > ngroups) nt = ngroups > 0 ? ngroups : 1;
        std::atomic<int> next(0);
        const size_t row = (size_t)(T.M + 1) * 16;
        auto work = [&]() {
            /* flush-to-zero: decayed odds cells hit denormals */
            _mm_setcsr(_mm_getcsr() | 0x8040);
            std::vector<float> bufA(row * 3 + 16), bufB(row * 3 + 16);
            std::vector<int32_t> xoffv;
            for (;;) {
                const int g = next.fetch_add(1);
                if (g >= ngroups) break;
                const int lo = g * 16;
                const int nl =
                    (int)std::min<Py_ssize_t>(16, N - lo);
                const int32_t *gc[16];
                int gl[16];
                int Lmax = 0;
                for (int l = 0; l < nl; l++) {
                    gc[l] = cptr[order[lo + l]];
                    gl[l] = clen[order[lo + l]];
                    Lmax = std::max(Lmax, gl[l]);
                }
                xoffv.resize((size_t)std::max(Lmax, 1) * 16);
                double outg[16];
                forward_group16(T, gc, gl, nl, bufA.data(), bufB.data(),
                                xoffv.data(), outg);
                for (int l = 0; l < nl; l++)
                    fwd[order[lo + l]] = outg[l];
            }
        };
        if (nt <= 1) work();
        else {
            std::vector<std::thread> threads;
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp dim = N;
    PyArrayObject *afwd = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    if (!afwd) return NULL;
    for (Py_ssize_t n = 0; n < N; n++)
        ((double *)PyArray_DATA(afwd))[n] = fwd[n];
    return (PyObject *)afwd;
#endif
}

#ifdef __AVX512F__
/* Lane-parallel EXACT f64 Forward: 8 targets per __m512d lane, the
 * same recurrence, rescale criterion (rs > 1e3 || rs < 1e-3, masked
 * per lane, by 1/rs itself) and scale-ledger semantics as the scalar
 * forward_region — used for the print-exact reported-score base so
 * evaluate_targets_rows can skip its per-pair full-sequence Forward
 * (want_fwd=0). Validated against the stored full-grid hmmsearch
 * oracle (docs/CALIBRATION.md). */
static void forward_group8_f64(const Model &mo,
                               const int32_t *const *cptr,
                               const int *clen, int nl,
                               double *bufA, double *bufB,
                               int32_t *xoff, double *out) {
    const int M = mo.M;
    const size_t row = (size_t)(M + 1) * 8;
    int Lmax = 0;
    for (int l = 0; l < nl; l++) Lmax = std::max(Lmax, clen[l]);

    alignas(64) double moved[8], loopd[8];
    for (int l = 0; l < 8; l++) {
        const double pmove =
            l < nl ? 3.0 / ((double)clen[l] + 3.0) : 1.0;
        moved[l] = pmove;
        loopd[l] = 1.0 - pmove;
    }
    for (int i = 0; i < Lmax; i++)
        for (int l = 0; l < 8; l++)
            xoff[(size_t)i * 8 + l] =
                (l < nl && i < clen[l]) ? cptr[l][i] * (M + 1) : 0;

    std::memset(bufA, 0, row * 3 * sizeof(double));
    std::memset(bufB, 0, row * 3 * sizeof(double));
    double *pm = bufA, *pi = bufA + row, *pd = bufA + 2 * row;
    double *cm = bufB, *ci = bufB + row, *cd = bufB + 2 * row;

    const __m512d zero = _mm512_setzero_pd();
    const __m512d half = _mm512_set1_pd(0.5);
    const __m512d loopv = _mm512_load_pd(loopd);
    const __m512d movev = _mm512_load_pd(moved);
    __m512d Nv = _mm512_set1_pd(1.0), Jv = zero, Cv = zero;
    __m512d Bv = movev;
    alignas(64) double slog[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int next_end = 0;                          /* lanes sorted by len */

    for (int i = 1; i <= Lmax; i++) {
        const __m256i xo = _mm256_loadu_si256(
            (const __m256i *)(xoff + (size_t)(i - 1) * 8));
        const __m512d Bprev = Bv;
        __m512d esum = zero;
        for (int k = 1; k <= M; k++) {
            /* same op order as forward_region: ((pm*mm + pi*im)
             * + pd*dm) + B*bmo, no FMA contraction */
            __m512d src = _mm512_add_pd(
                _mm512_add_pd(
                    _mm512_add_pd(
                        _mm512_mul_pd(_mm512_loadu_pd(pm + 8 * (k - 1)),
                                      _mm512_set1_pd(mo.mm[k - 1])),
                        _mm512_mul_pd(_mm512_loadu_pd(pi + 8 * (k - 1)),
                                      _mm512_set1_pd(mo.im[k - 1]))),
                    _mm512_mul_pd(_mm512_loadu_pd(pd + 8 * (k - 1)),
                                  _mm512_set1_pd(mo.dm[k - 1]))),
                _mm512_mul_pd(Bprev, _mm512_set1_pd(mo.bmo[k])));
            const __m256i idx =
                _mm256_add_epi32(xo, _mm256_set1_epi32(k));
            const __m512d ex =
                _mm512_i32gather_pd(idx, mo.emX.data(), 8);
            const __m512d v = _mm512_mul_pd(src, ex);
            _mm512_storeu_pd(cm + 8 * k, v);
            esum = _mm512_add_pd(esum, v);
            if (k < M) {
                const __m512d iv = _mm512_add_pd(
                    _mm512_mul_pd(_mm512_loadu_pd(pm + 8 * k),
                                  _mm512_set1_pd(mo.mi[k])),
                    _mm512_mul_pd(_mm512_loadu_pd(pi + 8 * k),
                                  _mm512_set1_pd(mo.ii[k])));
                _mm512_storeu_pd(ci + 8 * k, iv);
            }
        }
        _mm512_storeu_pd(ci + 8 * M, zero);
        __m512d dprev = zero;
        for (int k = 2; k <= M; k++) {
            const __m512d dk = _mm512_add_pd(
                _mm512_mul_pd(_mm512_loadu_pd(cm + 8 * (k - 1)),
                              _mm512_set1_pd(mo.md[k - 1])),
                _mm512_mul_pd(dprev, _mm512_set1_pd(mo.dd[k - 1])));
            _mm512_storeu_pd(cd + 8 * k, dk);
            esum = _mm512_add_pd(esum, dk);
            dprev = dk;
        }
        /* specials, scalar op order matching forward_region */
        Jv = _mm512_add_pd(_mm512_mul_pd(Jv, loopv),
                           _mm512_mul_pd(esum, half));
        Cv = _mm512_add_pd(_mm512_mul_pd(Cv, loopv),
                           _mm512_mul_pd(esum, half));
        Nv = _mm512_mul_pd(Nv, loopv);
        Bv = _mm512_add_pd(_mm512_mul_pd(Nv, movev),
                           _mm512_mul_pd(Jv, movev));
        /* per-lane conditional rescale by rs itself */
        const __m512d rs = _mm512_mask_blend_pd(
            _mm512_cmp_pd_mask(esum, zero, _CMP_GT_OQ), Cv, esum);
        const __mmask8 pos =
            _mm512_cmp_pd_mask(rs, zero, _CMP_GT_OQ);
        const __mmask8 big = _mm512_cmp_pd_mask(
            rs, _mm512_set1_pd(1e3), _CMP_GT_OQ);
        const __mmask8 small = _mm512_cmp_pd_mask(
            rs, _mm512_set1_pd(1e-3), _CMP_LT_OQ);
        const __mmask8 cond = pos & (__mmask8)(big | small);
        if (cond) {
            const __m512d inv = _mm512_mask_blend_pd(
                cond, _mm512_set1_pd(1.0),
                _mm512_div_pd(_mm512_set1_pd(1.0), rs));
            for (int k = 0; k <= M; k++) {
                _mm512_storeu_pd(cm + 8 * k, _mm512_mul_pd(
                    _mm512_loadu_pd(cm + 8 * k), inv));
                _mm512_storeu_pd(ci + 8 * k, _mm512_mul_pd(
                    _mm512_loadu_pd(ci + 8 * k), inv));
                _mm512_storeu_pd(cd + 8 * k, _mm512_mul_pd(
                    _mm512_loadu_pd(cd + 8 * k), inv));
            }
            Nv = _mm512_mul_pd(Nv, inv);
            Bv = _mm512_mul_pd(Bv, inv);
            Jv = _mm512_mul_pd(Jv, inv);
            Cv = _mm512_mul_pd(Cv, inv);
            esum = _mm512_mul_pd(esum, inv);
            alignas(64) double rsb[8];
            _mm512_store_pd(rsb, rs);
            for (int l = 0; l < 8; l++)
                if (cond & (1u << l)) slog[l] += std::log(rsb[l]);
        }
        while (next_end < nl && clen[next_end] == i) {
            alignas(64) double cbuf[8];
            _mm512_store_pd(cbuf, Cv);
            const int l = next_end++;
            out[l] = std::log(std::max(cbuf[l], 1e-300))
                   + std::log(moved[l]) + slog[l];
        }
        std::swap(pm, cm); std::swap(pi, ci); std::swap(pd, cd);
    }
    for (int l = 0; l < nl; l++)
        if (clen[l] == 0)
            out[l] = std::log(1e-300) + std::log(moved[l]);
}
#endif  /* __AVX512F__ */

/* forward_targets_exact(msc2d, tmm..bm, codes_list, nthreads)
 *   -> f64[N]
 * Lane-parallel exact f64 Forward (8 targets per vector); scalar
 * fallback without AVX-512. */
static PyObject *forward_targets_exact(PyObject *self, PyObject *args) {
#ifndef __AVX512F__
    return forward_targets(self, args);
#else
    PyObject *omsc, *ot[8], *olist;
    int nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptr;
    std::vector<int> clen;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptr, &clen))
        return NULL;
    Py_ssize_t N = (Py_ssize_t)cptr.size();
    std::vector<double> fwd(N, 0.0);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);
        std::vector<int> order(N);
        for (Py_ssize_t n = 0; n < N; n++) order[n] = (int)n;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            return clen[a] != clen[b] ? clen[a] < clen[b] : a < b;
        });
        const int ngroups = (int)((N + 7) / 8);
        int nt = nthreads < 1 ? 1 : (nthreads > 16 ? 16 : nthreads);
        if (nt > ngroups) nt = ngroups > 0 ? ngroups : 1;
        std::atomic<int> next(0);
        const size_t rowsz = (size_t)(mo.M + 1) * 8;
        auto work = [&]() {
            std::vector<double> bufA(rowsz * 3 + 8), bufB(rowsz * 3 + 8);
            std::vector<int32_t> xoffv;
            for (;;) {
                const int g = next.fetch_add(1);
                if (g >= ngroups) break;
                const int lo = g * 8;
                const int nl = (int)std::min<Py_ssize_t>(8, N - lo);
                const int32_t *gc[8];
                int gl[8];
                int Lg = 0;
                for (int l = 0; l < nl; l++) {
                    gc[l] = cptr[order[lo + l]];
                    gl[l] = clen[order[lo + l]];
                    Lg = std::max(Lg, gl[l]);
                }
                xoffv.resize((size_t)std::max(Lg, 1) * 8);
                double outg[8];
                forward_group8_f64(mo, gc, gl, nl, bufA.data(),
                                   bufB.data(), xoffv.data(), outg);
                for (int l = 0; l < nl; l++)
                    fwd[order[lo + l]] = outg[l];
            }
        };
        if (nt <= 1) work();
        else {
            std::vector<std::thread> threads;
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp dim = N;
    PyArrayObject *afwd = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    if (!afwd) return NULL;
    for (Py_ssize_t n = 0; n < N; n++)
        ((double *)PyArray_DATA(afwd))[n] = fwd[n];
    return (PyObject *)afwd;
#endif
}

#ifdef __AVX512F__
/* Lane-parallel F+B special-row posteriors (the reporting gate's
 * flank rows — mocc/ppB/ppE, f64 oracle hmm/domaindef.py:
 * _posteriors_multihit, device twin hmm/flank_device.py:_flank_one).
 * Forward and backward scans keep only the special-state rows plus a
 * power-of-2 exponent ledger per row; the combine runs in double so
 * mantissa products of 2^±28-ranged row values cannot overflow. */
static void flank_group16(const SimdTables &T,
                          const int32_t *const *cptr, const int *clen,
                          int nl, float *bufA, float *bufB,
                          int32_t *xoff, float *fspec, float *bspec,
                          npy_intp Lp1out, double *out_fwd,
                          float *out_mocc, float *out_ppb,
                          float *out_ppe) {
    const int M = T.M;
    const size_t row = (size_t)(M + 1) * 16;
    int Lmax = 0;
    for (int l = 0; l < nl; l++) Lmax = std::max(Lmax, clen[l]);

    alignas(64) float movef[16], loopf[16];
    for (int l = 0; l < 16; l++) {
        double pmove = l < nl ? 3.0 / ((double)clen[l] + 3.0) : 1.0;
        movef[l] = (float)pmove;
        loopf[l] = (float)(1.0 - pmove);
    }
    for (int i = 0; i < Lmax; i++)
        for (int l = 0; l < 16; l++)
            xoff[(size_t)i * 16 + l] =
                (l < nl && i < clen[l]) ? cptr[l][i] * (M + 1) : 0;

    const __m512 zero = _mm512_setzero_ps();
    const __m512 one = _mm512_set1_ps(1.0f);
    const __m512 half = _mm512_set1_ps(0.5f);
    const __m512 loopv = _mm512_load_ps(loopf);
    const __m512 movev = _mm512_load_ps(movef);
    /* specials layout per row i: [N, B, J, C, E, eledger] x 16 */
    const size_t srow = 6 * 16;
    auto spec = [&](float *base, int i, int f) {
        return base + (size_t)i * srow + (size_t)f * 16;
    };

    /* ---------------- forward ---------------- */
    std::memset(bufA, 0, row * 3 * sizeof(float));
    std::memset(bufB, 0, row * 3 * sizeof(float));
    float *pm = bufA, *pi = bufA + row, *pd = bufA + 2 * row;
    float *cm = bufB, *ci = bufB + row, *cd = bufB + 2 * row;
    {
        __m512 Nv = one, Jv = zero, Cv = zero, Bv = movev, etot = zero;
        _mm512_storeu_ps(spec(fspec, 0, 0), one);
        _mm512_storeu_ps(spec(fspec, 0, 1), movev);
        _mm512_storeu_ps(spec(fspec, 0, 2), zero);
        _mm512_storeu_ps(spec(fspec, 0, 3), zero);
        _mm512_storeu_ps(spec(fspec, 0, 4), zero);
        _mm512_storeu_ps(spec(fspec, 0, 5), zero);
        for (int i = 1; i <= Lmax; i++) {
            const __m512i xo = _mm512_loadu_si512(
                (const void *)(xoff + (size_t)(i - 1) * 16));
            const __m512 Bprev = Bv;
            __m512 esum = zero;
            for (int k = 1; k <= M; k++) {
                __m512 src =
                    _mm512_mul_ps(Bprev, _mm512_set1_ps(T.bmo[k]));
                src = _mm512_fmadd_ps(_mm512_loadu_ps(pm + 16 * (k - 1)),
                                      _mm512_set1_ps(T.mm[k - 1]), src);
                src = _mm512_fmadd_ps(_mm512_loadu_ps(pi + 16 * (k - 1)),
                                      _mm512_set1_ps(T.im[k - 1]), src);
                src = _mm512_fmadd_ps(_mm512_loadu_ps(pd + 16 * (k - 1)),
                                      _mm512_set1_ps(T.dm[k - 1]), src);
                const __m512i idx =
                    _mm512_add_epi32(xo, _mm512_set1_epi32(k));
                const __m512 ex =
                    _mm512_i32gather_ps(idx, T.emX.data(), 4);
                const __m512 v = _mm512_mul_ps(src, ex);
                _mm512_storeu_ps(cm + 16 * k, v);
                esum = _mm512_add_ps(esum, v);
                if (k < M) {
                    const __m512 iv = _mm512_fmadd_ps(
                        _mm512_loadu_ps(pm + 16 * k),
                        _mm512_set1_ps(T.mi[k]),
                        _mm512_mul_ps(_mm512_loadu_ps(pi + 16 * k),
                                      _mm512_set1_ps(T.ii[k])));
                    _mm512_storeu_ps(ci + 16 * k, iv);
                }
            }
            _mm512_storeu_ps(ci + 16 * M, zero);
            __m512 dprev = zero;
            for (int k = 2; k <= M; k++) {
                const __m512 t =
                    _mm512_mul_ps(_mm512_loadu_ps(cm + 16 * (k - 1)),
                                  _mm512_set1_ps(T.md[k - 1]));
                dprev = _mm512_fmadd_ps(dprev,
                                        _mm512_set1_ps(T.dd[k - 1]), t);
                _mm512_storeu_ps(cd + 16 * k, dprev);
                esum = _mm512_add_ps(esum, dprev);
            }
            Jv = _mm512_fmadd_ps(Jv, loopv, _mm512_mul_ps(esum, half));
            Cv = _mm512_fmadd_ps(Cv, loopv, _mm512_mul_ps(esum, half));
            Nv = _mm512_mul_ps(Nv, loopv);
            Bv = _mm512_mul_ps(_mm512_add_ps(Nv, Jv), movev);
            /* emit row i specials at the pre-rescale ledger */
            _mm512_storeu_ps(spec(fspec, i, 0), Nv);
            _mm512_storeu_ps(spec(fspec, i, 1), Bv);
            _mm512_storeu_ps(spec(fspec, i, 2), Jv);
            _mm512_storeu_ps(spec(fspec, i, 3), Cv);
            _mm512_storeu_ps(spec(fspec, i, 4), esum);
            _mm512_storeu_ps(spec(fspec, i, 5), etot);
            const __mmask16 gm =
                _mm512_cmp_ps_mask(esum, zero, _CMP_GT_OQ);
            const __m512 e = _mm512_maskz_getexp_ps(gm, esum);
            if (_mm512_reduce_max_ps(_mm512_abs_ps(e)) > 24.0f) {
                const __m512 sc =
                    _mm512_scalef_ps(one, _mm512_sub_ps(zero, e));
                for (int k = 0; k <= M; k++) {
                    _mm512_storeu_ps(cm + 16 * k, _mm512_mul_ps(
                        _mm512_loadu_ps(cm + 16 * k), sc));
                    _mm512_storeu_ps(ci + 16 * k, _mm512_mul_ps(
                        _mm512_loadu_ps(ci + 16 * k), sc));
                    _mm512_storeu_ps(cd + 16 * k, _mm512_mul_ps(
                        _mm512_loadu_ps(cd + 16 * k), sc));
                }
                Nv = _mm512_mul_ps(Nv, sc);
                Bv = _mm512_mul_ps(Bv, sc);
                Jv = _mm512_mul_ps(Jv, sc);
                Cv = _mm512_mul_ps(Cv, sc);
                etot = _mm512_add_ps(etot, e);
            }
            std::swap(pm, cm); std::swap(pi, ci); std::swap(pd, cd);
        }
    }

    /* ---------------- backward ---------------- */
    /* carry rows live at i+1 in bufA (Mn, In); bufB is scratch */
    std::memset(bufA, 0, row * 3 * sizeof(float));
    std::memset(bufB, 0, row * 3 * sizeof(float));
    float *Mn = bufA, *In = bufA + row;
    float *Mi = bufB, *Ii = bufB + row, *Dv = bufB + 2 * row;
    {
        /* terminal row L: E_L = move*0.5; D_L right-to-left chain;
         * Mn_L[k] = E_L + D_L[k+1]*t_md[k], Mn_L[0] = 0 */
        const __m512 EL = _mm512_mul_ps(movev, half);
        __m512 dnext = zero;
        for (int k = M; k >= 0; k--) {
            const __m512 mk =
                _mm512_fmadd_ps(dnext,
                                _mm512_set1_ps(T.md[k]), EL);
            _mm512_storeu_ps(Mn + 16 * k,
                             k == 0 ? zero : mk);
            dnext = _mm512_fmadd_ps(dnext,
                                    _mm512_set1_ps(T.dd[k]), EL);
        }
        std::memset(In, 0, row * sizeof(float));
        __m512 Nv = zero, Jv = zero, Cv = movev, etot = zero;
        /* backward specials of each lane's own row L are written
         * during the combine (they depend on per-lane length) */
        for (int i = Lmax - 1; i >= 0; i--) {
            /* lanes with clen == i+1 start their backward recursion
             * here: reset their carry to the terminal pattern */
            __mmask16 start = 0;
            for (int l = 0; l < nl; l++)
                if (clen[l] == i + 1) start |= (__mmask16)(1u << l);
            if (start) {
                Nv = _mm512_mask_blend_ps(start, Nv, zero);
                Jv = _mm512_mask_blend_ps(start, Jv, zero);
                Cv = _mm512_mask_blend_ps(start, Cv, movev);
                etot = _mm512_mask_blend_ps(start, etot, zero);
                const __m512 ELs = _mm512_mul_ps(movev, half);
                __m512 dn = zero;
                for (int k = M; k >= 0; k--) {
                    const __m512 mk = _mm512_fmadd_ps(
                        dn, _mm512_set1_ps(T.md[k]), ELs);
                    __m512 old = _mm512_loadu_ps(Mn + 16 * k);
                    _mm512_storeu_ps(Mn + 16 * k,
                                     _mm512_mask_blend_ps(
                                         start, old,
                                         k == 0 ? zero : mk));
                    old = _mm512_loadu_ps(In + 16 * k);
                    _mm512_storeu_ps(In + 16 * k,
                                     _mm512_mask_blend_ps(start, old,
                                                          zero));
                    dn = _mm512_fmadd_ps(dn, _mm512_set1_ps(T.dd[k]),
                                         ELs);
                }
            }
            const __m512i xo = _mm512_loadu_si512(
                (const void *)(xoff + (size_t)i * 16));
            /* mne[k] = Mn[k] * em[k][x]; Bv = sum bm[k]*mne[k] */
            __m512 Bsum = zero;
            for (int k = 1; k <= M; k++) {
                const __m512i idx =
                    _mm512_add_epi32(xo, _mm512_set1_epi32(k));
                const __m512 ex =
                    _mm512_i32gather_ps(idx, T.emX.data(), 4);
                const __m512 mne =
                    _mm512_mul_ps(_mm512_loadu_ps(Mn + 16 * k), ex);
                _mm512_storeu_ps(Dv + 16 * k, mne);   /* stash mne */
                Bsum = _mm512_fmadd_ps(mne, _mm512_set1_ps(T.bmo[k]),
                                       Bsum);
            }
            _mm512_storeu_ps(Dv, zero);               /* mne[0] */
            const __m512 Ni =
                _mm512_fmadd_ps(Nv, loopv, _mm512_mul_ps(Bsum, movev));
            const __m512 Ji =
                _mm512_fmadd_ps(Jv, loopv, _mm512_mul_ps(Bsum, movev));
            const __m512 Ci = _mm512_mul_ps(Cv, loopv);
            const __m512 Ei = _mm512_fmadd_ps(
                Ci, half, _mm512_mul_ps(Ji, half));
            /* emit row i specials (N, J, C, B, E) pre-rescale */
            _mm512_storeu_ps(spec(bspec, i, 0), Ni);
            _mm512_storeu_ps(spec(bspec, i, 1), Ji);
            _mm512_storeu_ps(spec(bspec, i, 2), Ci);
            _mm512_storeu_ps(spec(bspec, i, 3), Bsum);
            _mm512_storeu_ps(spec(bspec, i, 4), Ei);
            _mm512_storeu_ps(spec(bspec, i, 5), etot);
            /* D chain right-to-left, then M/I rows; mne is in Dv and
             * gets overwritten one step behind the reads */
            __m512 dnext2 = zero, mmax = zero;
            __m512 mne_next = zero;                   /* mne[k+1] */
            for (int k = M; k >= 1; k--) {
                const __m512 c =
                    _mm512_fmadd_ps(mne_next,
                                    _mm512_set1_ps(T.dm[k]), Ei);
                const __m512 dk =
                    _mm512_fmadd_ps(dnext2,
                                    _mm512_set1_ps(T.dd[k]), c);
                const __m512 mi2 = _mm512_add_ps(
                    Ei,
                    _mm512_fmadd_ps(mne_next, _mm512_set1_ps(T.mm[k]),
                        _mm512_fmadd_ps(
                            _mm512_loadu_ps(In + 16 * k),
                            _mm512_set1_ps(T.mi[k]),
                            _mm512_mul_ps(dnext2,
                                          _mm512_set1_ps(T.md[k])))));
                const __m512 ii2 = _mm512_fmadd_ps(
                    mne_next, _mm512_set1_ps(T.im[k]),
                    _mm512_mul_ps(_mm512_loadu_ps(In + 16 * k),
                                  _mm512_set1_ps(T.ii[k])));
                mne_next = _mm512_loadu_ps(Dv + 16 * k);
                _mm512_storeu_ps(Mi + 16 * k, mi2);
                _mm512_storeu_ps(Ii + 16 * k, ii2);
                _mm512_storeu_ps(Dv + 16 * k, dk);
                dnext2 = dk;
                mmax = _mm512_max_ps(mmax, mi2);
            }
            _mm512_storeu_ps(Mi, zero);
            _mm512_storeu_ps(Ii, zero);
            /* rescale on the row maximum (mirrors the device scan's
             * max(M, N, C) choice, power-of-2 ledger) */
            __m512 rmax = _mm512_max_ps(mmax, _mm512_max_ps(Ni, Ci));
            const __mmask16 gm =
                _mm512_cmp_ps_mask(rmax, zero, _CMP_GT_OQ);
            const __m512 e = _mm512_maskz_getexp_ps(gm, rmax);
            __m512 Nn = Ni, Jn = Ji, Cn = Ci;
            if (_mm512_reduce_max_ps(_mm512_abs_ps(e)) > 24.0f) {
                const __m512 sc =
                    _mm512_scalef_ps(one, _mm512_sub_ps(zero, e));
                for (int k = 0; k <= M; k++) {
                    _mm512_storeu_ps(Mi + 16 * k, _mm512_mul_ps(
                        _mm512_loadu_ps(Mi + 16 * k), sc));
                    _mm512_storeu_ps(Ii + 16 * k, _mm512_mul_ps(
                        _mm512_loadu_ps(Ii + 16 * k), sc));
                }
                Nn = _mm512_mul_ps(Nn, sc);
                Jn = _mm512_mul_ps(Jn, sc);
                Cn = _mm512_mul_ps(Cn, sc);
                etot = _mm512_add_ps(etot, e);
            }
            Nv = Nn; Jv = Jn; Cv = Cn;
            std::swap(Mn, Mi); std::swap(In, Ii);
        }
    }

    /* ---------------- combine (double, per lane) ---------------- */
    for (int l = 0; l < nl; l++) {
        const int L = clen[l];
        double *fwdp = out_fwd + l;
        float *mo = out_mocc + (size_t)l * Lp1out;
        float *pb = out_ppb + (size_t)l * Lp1out;
        float *pe = out_ppe + (size_t)l * Lp1out;
        std::memset(mo, 0, Lp1out * sizeof(float));
        std::memset(pb, 0, Lp1out * sizeof(float));
        std::memset(pe, 0, Lp1out * sizeof(float));
        const double move = 3.0 / ((double)L + 3.0);
        const double loop = 1.0 - move;
        const double fC = (double)fspec[(size_t)L * srow + 3 * 16 + l];
        const double feL = (double)fspec[(size_t)L * srow + 5 * 16 + l];
        const double fwdm = fC * move;
        *fwdp = fwdm > 0.0
            ? std::log(fwdm) + M_LN2 * feL : std::log(1e-300);
        if (fwdm <= 0.0 || L == 0) continue;
        /* backward specials of row L are the terminal pattern */
        const double bspecL[6] = {0.0, 0.0, move, 0.0, move * 0.5, 0.0};
        for (int i = 0; i <= L; i++) {
            const float *fr = fspec + (size_t)i * srow;
            const float *br_ = bspec + (size_t)i * srow;
            double bN, bJ, bC, bB, bE, be;
            if (i == L) {
                bN = bspecL[0]; bJ = bspecL[1]; bC = bspecL[2];
                bB = bspecL[3]; bE = bspecL[4]; be = bspecL[5];
            } else {
                bN = br_[0 * 16 + l]; bJ = br_[1 * 16 + l];
                bC = br_[2 * 16 + l]; bB = br_[3 * 16 + l];
                bE = br_[4 * 16 + l]; be = br_[5 * 16 + l];
            }
            const double fe = fr[5 * 16 + l];
            const double sE = std::ldexp(1.0, (int)(fe + be - feL));
            pb[i] = (float)((double)fr[1 * 16 + l] * bB * sE / fwdm);
            pe[i] = (float)((double)fr[4 * 16 + l] * bE * sE / fwdm);
            if (i >= 1) {
                const float *fp = fspec + (size_t)(i - 1) * srow;
                const double fpe = fp[5 * 16 + l];
                const double sP =
                    std::ldexp(1.0, (int)(fpe + be - feL));
                const double ppN =
                    (double)fp[0 * 16 + l] * loop * bN * sP / fwdm;
                const double ppJ =
                    (double)fp[2 * 16 + l] * loop * bJ * sP / fwdm;
                const double ppC =
                    (double)fp[3 * 16 + l] * loop * bC * sP / fwdm;
                mo[i] = (float)(1.0 - (ppN + ppJ + ppC));
            }
        }
    }
}
#endif  /* __AVX512F__ */

/* flank_targets_simd(msc2d, tmm..bm, codes_list, nthreads)
 *   -> (fwd f64[N], mocc f32[N, Lmax+1], ppB f32[N, Lmax+1],
 *       ppE f32[N, Lmax+1])
 * AVX-512 lane-parallel special-row posteriors for the reporting
 * gate; the rows feed evaluate_targets_rows, which then skips its
 * host full-sequence F+B. */
static PyObject *flank_targets_simd(PyObject *, PyObject *args) {
#ifndef __AVX512F__
    PyErr_SetString(PyExc_RuntimeError,
                    "extension built without AVX-512");
    return NULL;
#else
    PyObject *omsc, *ot[8], *olist;
    int nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptr;
    std::vector<int> clen;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptr, &clen))
        return NULL;
    Py_ssize_t N = (Py_ssize_t)cptr.size();
    int Lmax = 0;
    for (Py_ssize_t n = 0; n < N; n++) Lmax = std::max(Lmax, clen[n]);
    const npy_intp Lp1 = Lmax + 1;
    npy_intp dim1 = N, dims2[2] = {N, Lp1};
    PyArrayObject *afwd = (PyArrayObject *)PyArray_SimpleNew(
        1, &dim1, NPY_FLOAT64);
    PyArrayObject *amocc = (PyArrayObject *)PyArray_ZEROS(
        2, dims2, NPY_FLOAT32, 0);
    PyArrayObject *appb = (PyArrayObject *)PyArray_ZEROS(
        2, dims2, NPY_FLOAT32, 0);
    PyArrayObject *appe = (PyArrayObject *)PyArray_ZEROS(
        2, dims2, NPY_FLOAT32, 0);
    if (!afwd || !amocc || !appb || !appe) {
        Py_XDECREF(afwd); Py_XDECREF(amocc);
        Py_XDECREF(appb); Py_XDECREF(appe);
        return NULL;
    }
    double *ofwd = (double *)PyArray_DATA(afwd);
    float *omoc = (float *)PyArray_DATA(amocc);
    float *opb = (float *)PyArray_DATA(appb);
    float *ope = (float *)PyArray_DATA(appe);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);
        SimdTables T;
        build_simd_tables(mo, &T);
        std::vector<int> order(N);
        for (Py_ssize_t n = 0; n < N; n++) order[n] = (int)n;
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            return clen[a] != clen[b] ? clen[a] < clen[b] : a < b;
        });
        const int ngroups = (int)((N + 15) / 16);
        int nt = nthreads < 1 ? 1 : (nthreads > 16 ? 16 : nthreads);
        if (nt > ngroups) nt = ngroups > 0 ? ngroups : 1;
        std::atomic<int> next(0);
        const size_t rowsz = (size_t)(T.M + 1) * 16;
        auto work = [&]() {
            _mm_setcsr(_mm_getcsr() | 0x8040);
            std::vector<float> bufA(rowsz * 3 + 16),
                bufB(rowsz * 3 + 16);
            std::vector<float> fspec, bspec;
            std::vector<int32_t> xoffv;
            for (;;) {
                const int g = next.fetch_add(1);
                if (g >= ngroups) break;
                const int lo = g * 16;
                const int nl = (int)std::min<Py_ssize_t>(16, N - lo);
                const int32_t *gc[16];
                int gl[16];
                int Lg = 0;
                for (int l = 0; l < nl; l++) {
                    gc[l] = cptr[order[lo + l]];
                    gl[l] = clen[order[lo + l]];
                    Lg = std::max(Lg, gl[l]);
                }
                xoffv.resize((size_t)std::max(Lg, 1) * 16);
                fspec.resize((size_t)(Lg + 1) * 6 * 16);
                bspec.resize((size_t)(Lg + 1) * 6 * 16);
                double gfwd[16];
                std::vector<float> gmoc((size_t)16 * Lp1),
                    gpb((size_t)16 * Lp1), gpe((size_t)16 * Lp1);
                flank_group16(T, gc, gl, nl, bufA.data(), bufB.data(),
                              xoffv.data(), fspec.data(), bspec.data(),
                              Lp1, gfwd, gmoc.data(), gpb.data(),
                              gpe.data());
                for (int l = 0; l < nl; l++) {
                    const int n = order[lo + l];
                    ofwd[n] = gfwd[l];
                    std::memcpy(omoc + (size_t)n * Lp1,
                                gmoc.data() + (size_t)l * Lp1,
                                Lp1 * sizeof(float));
                    std::memcpy(opb + (size_t)n * Lp1,
                                gpb.data() + (size_t)l * Lp1,
                                Lp1 * sizeof(float));
                    std::memcpy(ope + (size_t)n * Lp1,
                                gpe.data() + (size_t)l * Lp1,
                                Lp1 * sizeof(float));
                }
            }
        };
        if (nt <= 1) work();
        else {
            std::vector<std::thread> threads;
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    PyObject *ret = PyTuple_Pack(4, (PyObject *)afwd, (PyObject *)amocc,
                                 (PyObject *)appb, (PyObject *)appe);
    Py_DECREF(afwd); Py_DECREF(amocc); Py_DECREF(appb); Py_DECREF(appe);
    return ret;
#endif
}

/* evaluate_targets(msc2d, tmm..bm, codes_list, seed, nsamples,
 *                  want_null2, nthreads)
 * One model vs many targets; returns (nregions i32[N], nenvelopes
 * i32[N], seqbias f64[N] in nats, plus the p7_pipeline sum_score
 * ("reconstruction") inputs sum_env f64[N] / sum_bias f64[N] / ld
 * i32[N]). */
static PyObject *evaluate_targets(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *olist;
    int seed, nsamples, want_null2, nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOiiii", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &seed, &nsamples,
                          &want_null2, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptrv;
    std::vector<int> clenv;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptrv, &clenv))
        return NULL;
    std::vector<const int32_t *> &cptr = cptrv;
    std::vector<int> &clen = clenv;
    Py_ssize_t N = (Py_ssize_t)cptr.size();
    std::vector<int> nreg(N, 0), nenv(N, 0), ld(N, 0);
    std::vector<double> bias(N, 0.0), fwd(N, 0.0),
        senv(N, 0.0), sbias(N, 0.0);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);   /* length set per target inside evaluate */
        mo.build_oprof();  /* shared read-only by the worker threads */
        int nt = nthreads < 1 ? 1 : nthreads;
        if (nt > 16) nt = 16;
        std::vector<std::thread> threads;
        std::atomic<Py_ssize_t> next(0);
        auto work = [&]() {
            for (;;) {
                Py_ssize_t n = next.fetch_add(1);
                if (n >= N) break;
                TargetResult tr;
                evaluate_target(mo, cptr[n], clen[n], (uint32_t)seed,
                                nsamples, want_null2 != 0, &tr);
                nreg[n] = tr.nregions;
                nenv[n] = tr.nenvelopes;
                bias[n] = tr.seqbias_nats;
                fwd[n] = tr.fwd_nats;
                senv[n] = tr.sum_env_nats;
                sbias[n] = tr.sum_bias_nats;
                ld[n] = tr.ld;
            }
        };
        if (nt == 1) work();
        else {
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp dim = N;
    PyArrayObject *areg = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_INT32);
    PyArrayObject *aenv = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_INT32);
    PyArrayObject *abia = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *afwd = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *asen = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *asbi = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *ald = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                            NPY_INT32);
    if (!areg || !aenv || !abia || !afwd || !asen || !asbi || !ald) {
        Py_XDECREF(areg); Py_XDECREF(aenv); Py_XDECREF(abia);
        Py_XDECREF(afwd); Py_XDECREF(asen); Py_XDECREF(asbi);
        Py_XDECREF(ald);
        return NULL;
    }
    for (Py_ssize_t n = 0; n < N; n++) {
        ((int32_t *)PyArray_DATA(areg))[n] = nreg[n];
        ((int32_t *)PyArray_DATA(aenv))[n] = nenv[n];
        ((double *)PyArray_DATA(abia))[n] = bias[n];
        ((double *)PyArray_DATA(afwd))[n] = fwd[n];
        ((double *)PyArray_DATA(asen))[n] = senv[n];
        ((double *)PyArray_DATA(asbi))[n] = sbias[n];
        ((int32_t *)PyArray_DATA(ald))[n] = ld[n];
    }
    PyObject *ret = PyTuple_Pack(7, (PyObject *)areg, (PyObject *)aenv,
                                 (PyObject *)abia, (PyObject *)afwd,
                                 (PyObject *)asen, (PyObject *)asbi,
                                 (PyObject *)ald);
    Py_DECREF(areg); Py_DECREF(aenv); Py_DECREF(abia); Py_DECREF(afwd);
    Py_DECREF(asen); Py_DECREF(asbi); Py_DECREF(ald);
    return ret;
}


/* evaluate_targets_rows(msc2d, tmm..bm, codes_list, seed, nsamples,
 *                       want_null2, want_fwd, mocc2d f32 [N, Lp1],
 *                       ppB2d f32 [N, Lp1], ppE2d f32 [N, Lp1],
 *                       nthreads)
 * Same contract as evaluate_targets, but the flank posterior rows
 * come from the caller (device-batched Forward+Backward scans,
 * witch_tpu/hmm/flank_device.py) so the full-sequence host
 * F+B per pair is skipped. want_fwd=1 runs the f64 Forward for the
 * print-exact reported score (Forward-only: ~half the F+B cost);
 * want_fwd=0 leaves fwd at 0 (gate-only use). Row conventions match
 * hmm/domaindef.py: mocc/ppB/ppE are full-sequence posterior rows
 * indexed 0..L; internally dB[i] = ppB[i-1], dE[i] = ppE[i]. */
static PyObject *evaluate_targets_rows(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *olist, *omocc, *oppb, *oppe;
    int seed, nsamples, want_null2, want_fwd, nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOiiiiOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &seed, &nsamples,
                          &want_null2, &want_fwd, &omocc, &oppb, &oppe,
                          &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptr;
    std::vector<int> clen;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptr, &clen))
        return NULL;
    Py_ssize_t N = (Py_ssize_t)cptr.size();
    PyArrayObject *ar[3] = {(PyArrayObject *)omocc,
                            (PyArrayObject *)oppb,
                            (PyArrayObject *)oppe};
    npy_intp Lp1 = 0;
    for (int r = 0; r < 3; r++) {
        if (!PyArray_Check((PyObject *)ar[r]) ||
            PyArray_TYPE(ar[r]) != NPY_FLOAT32 ||
            PyArray_NDIM(ar[r]) != 2 ||
            !PyArray_IS_C_CONTIGUOUS(ar[r]) ||
            PyArray_DIM(ar[r], 0) != N) {
            PyErr_SetString(PyExc_TypeError,
                            "rows must be f32 2D [N, Lmax+1]");
            return NULL;
        }
        if (r == 0) Lp1 = PyArray_DIM(ar[r], 1);
        else if (PyArray_DIM(ar[r], 1) != Lp1) {
            PyErr_SetString(PyExc_ValueError, "row widths differ");
            return NULL;
        }
    }
    for (Py_ssize_t n = 0; n < N; n++) {
        if (clen[n] + 1 > Lp1) {
            PyErr_SetString(PyExc_ValueError,
                            "rows narrower than a target");
            return NULL;
        }
    }
    const float *pm = (const float *)PyArray_DATA(ar[0]);
    const float *pb = (const float *)PyArray_DATA(ar[1]);
    const float *pe = (const float *)PyArray_DATA(ar[2]);
    std::vector<int> nreg(N, 0), nenv(N, 0), ld(N, 0);
    std::vector<double> bias(N, 0.0), fwd(N, 0.0),
        senv(N, 0.0), sbias(N, 0.0);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);
        mo.build_oprof();  /* shared read-only by the worker threads */
        int nt = nthreads < 1 ? 1 : nthreads;
        if (nt > 16) nt = 16;
        std::vector<std::thread> threads;
        std::atomic<Py_ssize_t> next(0);
        auto work = [&]() {
            for (;;) {
                Py_ssize_t n = next.fetch_add(1);
                if (n >= N) break;
                int L = clen[n];
                Model m = mo;
                m.set_length(L, true);
                TargetResult tr;
                if (want_fwd) {
                    Fwd f;
                    forward_region(m, cptr[n], L, &f);
                    tr.fwd_nats = std::log(std::max(f.C[L], 1e-300))
                                + std::log(m.move) + f.scale_log[L];
                }
                std::vector<double> mocc(L + 1, 0.0), dB(L + 1, 0.0),
                    dE(L + 1, 0.0);
                const float *rm = pm + (size_t)n * Lp1;
                const float *rb = pb + (size_t)n * Lp1;
                const float *re = pe + (size_t)n * Lp1;
                for (int i = 1; i <= L; i++) {
                    mocc[i] = (double)rm[i];
                    dB[i] = (double)rb[i - 1];
                    dE[i] = (double)re[i];
                }
                evaluate_target_rows(mo, m, cptr[n], L, (uint32_t)seed,
                                     nsamples, want_null2 != 0,
                                     mocc, dB, dE, &tr);
                nreg[n] = tr.nregions;
                nenv[n] = tr.nenvelopes;
                bias[n] = tr.seqbias_nats;
                fwd[n] = tr.fwd_nats;
                senv[n] = tr.sum_env_nats;
                sbias[n] = tr.sum_bias_nats;
                ld[n] = tr.ld;
            }
        };
        if (nt == 1) work();
        else {
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp dim = N;
    PyArrayObject *areg = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_INT32);
    PyArrayObject *aenv = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_INT32);
    PyArrayObject *abia = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *afwd = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *asen = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *asbi = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                             NPY_FLOAT64);
    PyArrayObject *ald = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                            NPY_INT32);
    if (!areg || !aenv || !abia || !afwd || !asen || !asbi || !ald) {
        Py_XDECREF(areg); Py_XDECREF(aenv); Py_XDECREF(abia);
        Py_XDECREF(afwd); Py_XDECREF(asen); Py_XDECREF(asbi);
        Py_XDECREF(ald);
        return NULL;
    }
    for (Py_ssize_t n = 0; n < N; n++) {
        ((int32_t *)PyArray_DATA(areg))[n] = nreg[n];
        ((int32_t *)PyArray_DATA(aenv))[n] = nenv[n];
        ((double *)PyArray_DATA(abia))[n] = bias[n];
        ((double *)PyArray_DATA(afwd))[n] = fwd[n];
        ((double *)PyArray_DATA(asen))[n] = senv[n];
        ((double *)PyArray_DATA(asbi))[n] = sbias[n];
        ((int32_t *)PyArray_DATA(ald))[n] = ld[n];
    }
    PyObject *ret = PyTuple_Pack(7, (PyObject *)areg, (PyObject *)aenv,
                                 (PyObject *)abia, (PyObject *)afwd,
                                 (PyObject *)asen, (PyObject *)asbi,
                                 (PyObject *)ald);
    Py_DECREF(areg); Py_DECREF(aenv); Py_DECREF(abia); Py_DECREF(afwd);
    Py_DECREF(asen); Py_DECREF(asbi); Py_DECREF(ald);
    return ret;
}


/* posterior_pair(msc2d, tmm..bm, codes_i32, Lmodel, multihit)
 * Unihit/multihit posterior decode of one (model, query) pair in f64:
 * returns (ppM [L+1,M+1], ppI [L+1,M+1], ppN [L+1], ppJ [L+1],
 * ppC [L+1]) — the dense inputs of the OA kernel (native/_oa).
 * Lmodel: length-model L (the aligner uses the query length; the
 * rescore semantics use the full sequence length). */
static PyObject *posterior_pair(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    int Lmodel, multihit;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOii", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lmodel, &multihit))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    if (!PyArray_Check(omsc) || PyArray_TYPE(amsc) != NPY_FLOAT64 ||
        PyArray_NDIM(amsc) != 2 || !PyArray_IS_C_CONTIGUOUS(amsc)) {
        PyErr_SetString(PyExc_TypeError, "msc must be f64 2D");
        return NULL;
    }
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
        if (tn != mo.M + 1) {
            PyErr_SetString(PyExc_ValueError, "transition length != M+1");
            return NULL;
        }
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    if (!PyArray_Check(ocodes) || PyArray_TYPE(ac) != NPY_INT32 ||
        PyArray_NDIM(ac) != 1 || !PyArray_IS_C_CONTIGUOUS(ac)) {
        PyErr_SetString(PyExc_TypeError, "codes must be i32 1D");
        return NULL;
    }
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    for (int i = 0; i < L; i++)
        if (codes[i] < 0 || codes[i] >= mo.K) {
            PyErr_SetString(PyExc_ValueError, "code out of range");
            return NULL;
        }
    int M = mo.M;
    npy_intp d2[2] = {L + 1, M + 1};
    npy_intp d1 = L + 1;
    PyArrayObject *apM = (PyArrayObject *)PyArray_ZEROS(2, d2, NPY_FLOAT64, 0);
    PyArrayObject *apI = (PyArrayObject *)PyArray_ZEROS(2, d2, NPY_FLOAT64, 0);
    PyArrayObject *apN = (PyArrayObject *)PyArray_ZEROS(1, &d1, NPY_FLOAT64, 0);
    PyArrayObject *apJ = (PyArrayObject *)PyArray_ZEROS(1, &d1, NPY_FLOAT64, 0);
    PyArrayObject *apC = (PyArrayObject *)PyArray_ZEROS(1, &d1, NPY_FLOAT64, 0);
    if (!apM || !apI || !apN || !apJ || !apC) {
        Py_XDECREF(apM); Py_XDECREF(apI); Py_XDECREF(apN);
        Py_XDECREF(apJ); Py_XDECREF(apC);
        return NULL;
    }
    double *pM = (double *)PyArray_DATA(apM);
    double *pI = (double *)PyArray_DATA(apI);
    double *pN = (double *)PyArray_DATA(apN);
    double *pJ = (double *)PyArray_DATA(apJ);
    double *pC = (double *)PyArray_DATA(apC);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(Lmodel);
        mo.set_length(Lmodel, multihit != 0);
        if (multihit) {
            Fwd f; Bck b;
            forward_region(mo, codes, L, &f);
            backward_full(mo, codes, L, &b);
            double tot = std::log(std::max(b.N[0], 1e-300)) + b.scale_log[0];
            for (int i = 1; i <= L; i++) {
                double sc = std::exp(f.scale_log[i] + b.scale_log[i] - tot);
                double sc1 = std::exp(f.scale_log[i - 1] + b.scale_log[i]
                                      - tot);
                const double *fm = f.rowM(i);
                const double *fi = f.rowI(i);
                const double *bmr = b.rowM(i);
                const double *bir = b.rowI(i);
                for (int k = 1; k <= M; k++) {
                    pM[(size_t)i * (M + 1) + k] = fm[k] * bmr[k] * sc;
                    pI[(size_t)i * (M + 1) + k] = fi[k] * bir[k] * sc;
                }
                pN[i] = f.N[i - 1] * mo.loop * b.N[i] * sc1;
                pJ[i] = f.J[i - 1] * mo.loop * b.J[i] * sc1;
                pC[i] = f.C[i - 1] * mo.loop * b.C[i] * sc1;
            }
        } else {
            /* unihit forward + fused rolling backward (J disabled,
             * E->C move = 1): posterior rows are written the moment
             * each backward row exists; the normalizer is the forward
             * total (equal to the backward total up to rounding). */
            Fwd f;
            double tot = unihit_forward(mo, codes, L, &f);
            std::vector<double> bm0(M+1,0.0), bm1(M+1,0.0),
                bi0(M+1,0.0), bi1(M+1,0.0), Dk(M+1,0.0);
            std::vector<double> bNv(L+1,0.0), bCv(L+1,0.0), slv(L+1,0.0);
            double bN = 0.0, bC = mo.move, bE = bC, sl = 0.0;
            bNv[L] = bN; bCv[L] = bC; slv[L] = sl;
            auto write_row = [&](int i, const double *bm_,
                                 const double *bi_, double sl_i) {
                double sc = std::exp(f.scale_log[i] + sl_i - tot);
                const double *fm = f.rowM(i);
                const double *fi = f.rowI(i);
                double *oM = &pM[(size_t)i*(M+1)];
                double *oI = &pI[(size_t)i*(M+1)];
                int k = 1;
#ifdef WT_ROWS_AVX512
                __m512d vsc = _mm512_set1_pd(sc);
                for (; k + 7 <= M; k += 8) {
                    _mm512_storeu_pd(oM + k, _mm512_mul_pd(_mm512_mul_pd(
                        _mm512_loadu_pd(fm + k),
                        _mm512_loadu_pd(bm_ + k)), vsc));
                    _mm512_storeu_pd(oI + k, _mm512_mul_pd(_mm512_mul_pd(
                        _mm512_loadu_pd(fi + k),
                        _mm512_loadu_pd(bi_ + k)), vsc));
                }
#endif
                for (; k <= M; k++) {
                    oM[k] = fm[k]*bm_[k]*sc;
                    oI[k] = fi[k]*bi_[k]*sc;
                }
            };
            {   /* row L boundary */
                Dk[M] = bE;
                for (int k = M - 1; k >= 1; k--)
                    Dk[k] = Dk[k + 1] * mo.dd[k] + bE;
                double *bm_ = bm1.data();
                bm_[0] = 0.0;
                for (int k = 1; k <= M; k++)
                    bm_[k] = bE + (k < M ? Dk[k + 1] * mo.md[k] : 0.0);
                if (L >= 1) write_row(L, bm_, bi1.data(), sl);
            }
            for (int i = L - 1; i >= 0; i--) {
                const double *Mn = ((L - i) & 1) ? bm1.data() : bm0.data();
                const double *In = ((L - i) & 1) ? bi1.data() : bi0.data();
                double *bm_ = ((L - i) & 1) ? bm0.data() : bm1.data();
                double *bi_ = ((L - i) & 1) ? bi0.data() : bi1.data();
                int x = codes[i];
                const double *ex = &mo.emX[(size_t)x * (M + 1)];
                double Bv = row_dot3(mo.bmo.data(), ex, Mn, M);
                bN = bN * mo.loop + Bv * mo.move;
                bC = bC * mo.loop;
                bE = bC;
                row_bck_dchain(Mn, ex, mo.dm.data(), mo.dd.data(), bE,
                               Dk.data(), M);
                double mx = row_bck_mi(Mn, In, ex, mo.mm.data(),
                                       mo.mi.data(), mo.md.data(),
                                       mo.im.data(), mo.ii.data(),
                                       Dk.data(), bE, bm_, bi_, M);
                if (mx > 0.0 && (mx > 1e3 || mx < 1e-3)) {
                    double inv = 1.0 / mx;
                    row_scale(bm_, inv, M);
                    row_scale(bi_, inv, M);
                    bN *= inv; bC *= inv; bE *= inv;
                    row_scale(Dk.data(), inv, M);
                    sl += std::log(mx);
                }
                bNv[i] = bN; bCv[i] = bC; slv[i] = sl;
                if (i >= 1) write_row(i, bm_, bi_, sl);
            }
            for (int i = 1; i <= L; i++) {
                double sc1 = std::exp(f.scale_log[i-1] + slv[i] - tot);
                pN[i] = f.N[i-1]*mo.loop*bNv[i]*sc1;
                pC[i] = f.C[i-1]*mo.loop*bCv[i]*sc1;
                pJ[i] = 0.0;
            }
        }
        Py_END_ALLOW_THREADS
    }
    PyObject *ret = PyTuple_Pack(5, (PyObject *)apM, (PyObject *)apI,
                                 (PyObject *)apN, (PyObject *)apJ,
                                 (PyObject *)apC);
    Py_DECREF(apM); Py_DECREF(apI); Py_DECREF(apN);
    Py_DECREF(apJ); Py_DECREF(apC);
    return ret;
}

/* ---- fused posterior + optimal-accuracy alignment ------------------- */

/* OA fill + traceback on dense pp planes (bit-identical port of
 * native/oa_kernel.cpp's oa_align, operating on raw pointers so the
 * fused path below can feed it scratch buffers without the numpy
 * round-trip).  Returns 0 on success, -1 on non-termination. */
static int oa_core(const double *ppM, const double *ppI,
                   const double *ppN, const double *ppJ,
                   const double *ppC, int L, int M,
                   const unsigned char *dmm, const unsigned char *dmi,
                   const unsigned char *dmd, const unsigned char *dim,
                   const unsigned char *dii, const unsigned char *ddm,
                   const unsigned char *ddd, const unsigned char *dbm,
                   int multihit, int64_t *cols) {
    static const double NEG = -std::numeric_limits<double>::infinity();
    const double DELTA_OFF = 1.1754943508222875e-38;   /* FLT_MIN */
    const size_t rowsz = (size_t)(M + 1);
    for (int i = 0; i < L; i++) cols[i] = -1;
    std::vector<double> mrow0(rowsz, NEG), mrow1(rowsz, NEG),
        irow0(rowsz, NEG), irow1(rowsz, NEG),
        drow0(rowsz, NEG), drow1(rowsz, NEG);
    std::vector<unsigned char> ptr((size_t)(L + 1) * rowsz, 0);
    std::vector<double> N(L + 1, 0.0), B(L + 1, 0.0), E(L + 1, NEG),
        J(L + 1, NEG), C(L + 1, NEG);
    std::vector<npy_intp> ek(L + 1, 1);
    std::vector<unsigned char> ed(L + 1, 0);
    auto DEL = [&](unsigned char f) { return f ? 1.0 : DELTA_OFF; };

    for (int i = 1; i <= L; i++) {
        const double *pMr = (i & 1) ? mrow0.data() : mrow1.data();
        const double *pIr = (i & 1) ? irow0.data() : irow1.data();
        const double *pDr = (i & 1) ? drow0.data() : drow1.data();
        double *cM = (i & 1) ? mrow1.data() : mrow0.data();
        double *cI = (i & 1) ? irow1.data() : irow0.data();
        double *cD = (i & 1) ? drow1.data() : drow0.data();
        unsigned char *pt = &ptr[(size_t)i * rowsz];
        cM[0] = NEG; cI[0] = NEG; cD[0] = NEG;
        cD[1] = NEG;
        double emax = NEG;
        const double Bprev = B[i - 1];
        double dacc = NEG;
        const double *ppMi = ppM + (size_t)i * rowsz;
        const double *ppIi = ppI + (size_t)i * rowsz;
        for (int k = 1; k <= M; k++) {
            const double pm = ppMi[k];
            const double c0 = DEL(dmm[k - 1]) * pMr[k - 1];
            const double c1 = DEL(dim[k - 1]) * pIr[k - 1];
            const double c2 = DEL(ddm[k - 1]) * pDr[k - 1];
            const double c3 = DEL(dbm[k]) * Bprev;
            double best = c0;
            unsigned char which = 0;
            if (c1 > best) { best = c1; which = 1; }
            if (c2 > best) { best = c2; which = 2; }
            if (c3 > best) { best = c3; which = 3; }
            const double mval = pm + best;
            cM[k] = mval;
            unsigned char pb = which;
            if (k < M) {
                const double a = DEL(dmi[k]) * pMr[k];
                const double b = DEL(dii[k]) * pIr[k];
                if (!(a >= b)) pb |= 4;
                cI[k] = ppIi[k] + (a >= b ? a : b);
            } else {
                cI[k] = NEG;
            }
            if (k >= 2) {
                const double md = DEL(dmd[k - 1]) * cM[k - 1];
                const double dc = DEL(ddd[k - 1]) * cD[k - 1];
                if (!(md >= dc)) pb |= 8;
                if (md > dacc) dacc = md;
                cD[k] = dacc;
                if (dacc > emax) emax = dacc;
            }
            if (mval > emax) emax = mval;
            pt[k] = pb;
        }
        {
            double best = NEG;
            npy_intp kmax = 1;
            unsigned char dmx = 0;
            for (int kk = 1; kk <= M; kk++) {
                if (cM[kk] > best) { best = cM[kk]; kmax = kk; dmx = 0; }
                if (cD[kk] > best) { best = cD[kk]; kmax = kk; dmx = 1; }
            }
            ek[i] = kmax;
            ed[i] = dmx;
        }
        E[i] = emax;
        const double jloop = (J[i - 1] == NEG) ? NEG : J[i - 1] + ppJ[i];
        J[i] = multihit ? (jloop > emax ? jloop : emax) : jloop;
        const double cloop = (std::isfinite(C[i - 1]))
                                 ? C[i - 1] + ppC[i] : NEG;
        C[i] = cloop > emax ? cloop : emax;
        N[i] = N[i - 1] + ppN[i];
        if (multihit && J[i] > N[i]) B[i] = J[i];
        else B[i] = N[i];
    }

    int i = L, k = 0;
    enum { S_C, S_J, S_E, S_M, S_I, S_D, S_B, S_N } st = S_C;
    long max_steps = 4 * (long)(L + M) + 16;
    long steps = 0;
    while (!(st == S_N && i == 0)) {
        if (++steps > max_steps || i < 0) return -1;
        switch (st) {
        case S_C: {
            const double loop = (i > 0 && std::isfinite(C[i - 1]))
                                    ? C[i - 1] + ppC[i] : NEG;
            if (loop >= E[i]) i -= 1;
            else st = S_E;
            break;
        }
        case S_J: {
            const double loop = (i > 0 && std::isfinite(J[i - 1]))
                                    ? J[i - 1] + ppJ[i] : NEG;
            if (loop >= E[i]) i -= 1;
            else st = S_E;
            break;
        }
        case S_E:
            k = (int)ek[i];
            st = ed[i] ? S_D : S_M;
            break;
        case S_M: {
            if (i >= 1 && i <= L) cols[i - 1] = k - 1;
            switch (ptr[(size_t)i * rowsz + k] & 3) {
            case 0: st = S_M; k -= 1; break;
            case 1: st = S_I; k -= 1; break;
            case 2: st = S_D; k -= 1; break;
            case 3: st = S_B; break;
            }
            i -= 1;
            break;
        }
        case S_I:
            st = (ptr[(size_t)i * rowsz + k] & 4) ? S_I : S_M;
            i -= 1;
            break;
        case S_D:
            st = S_D;
            if (!(ptr[(size_t)i * rowsz + k] & 8)) st = S_M;
            k -= 1;
            break;
        case S_B:
            st = (multihit && J[i] > N[i]) ? S_J : S_N;
            break;
        case S_N:
            i -= 1;
            break;
        }
    }
    return 0;
}

/* posterior_oa_pair(msc, t.., bm, codes, Lmodel, multihit,
 *                   dmm..dbm u8[M+1] x8) -> aligned columns i64[L]
 *
 * Fused unihit posterior decode + OA fill/trace for one pair: the
 * exact computation of posterior_pair followed by oa_align's DP, but
 * through reusable malloc'd scratch instead of five numpy arrays —
 * the split path moved ~100 MB per pair through zeroed/copied numpy
 * buffers, which made the per-query alignment stage memory-bound.
 * Outputs are bit-identical to the split path by construction. */
static PyObject *posterior_oa_pair(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes, *od[8];
    int Lmodel, multihit;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOiiOOOOOOOO", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lmodel, &multihit,
                          &od[0], &od[1], &od[2], &od[3], &od[4], &od[5],
                          &od[6], &od[7]))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    if (!PyArray_Check(omsc) || PyArray_TYPE(amsc) != NPY_FLOAT64 ||
        PyArray_NDIM(amsc) != 2 || !PyArray_IS_C_CONTIGUOUS(amsc)) {
        PyErr_SetString(PyExc_TypeError, "msc must be f64 2D");
        return NULL;
    }
    if (multihit) {
        PyErr_SetString(PyExc_ValueError,
                        "fused path is unihit-only (the aligner's mode)");
        return NULL;
    }
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
        if (tn != mo.M + 1) {
            PyErr_SetString(PyExc_ValueError, "transition length != M+1");
            return NULL;
        }
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    const unsigned char *du[8];
    for (int i = 0; i < 8; i++) {
        PyArrayObject *a = (PyArrayObject *)od[i];
        if (!PyArray_Check(od[i]) || PyArray_TYPE(a) != NPY_UINT8 ||
            PyArray_NDIM(a) != 1 || !PyArray_IS_C_CONTIGUOUS(a) ||
            PyArray_DIM(a, 0) != mo.M + 1) {
            PyErr_SetString(PyExc_TypeError,
                            "delta flags must be u8[M+1]");
            return NULL;
        }
        du[i] = (const unsigned char *)PyArray_DATA(a);
    }
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    if (!PyArray_Check(ocodes) || PyArray_TYPE(ac) != NPY_INT32 ||
        PyArray_NDIM(ac) != 1 || !PyArray_IS_C_CONTIGUOUS(ac)) {
        PyErr_SetString(PyExc_TypeError, "codes must be i32 1D");
        return NULL;
    }
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    for (int i = 0; i < L; i++)
        if (codes[i] < 0 || codes[i] >= mo.K) {
            PyErr_SetString(PyExc_ValueError, "code out of range");
            return NULL;
        }
    int M = mo.M;
    npy_intp d1 = L;
    PyArrayObject *out = (PyArrayObject *)PyArray_SimpleNew(1, &d1,
                                                            NPY_INT64);
    if (!out) return NULL;
    int64_t *cols = (int64_t *)PyArray_DATA(out);
    int rc = 0;
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(Lmodel);
        mo.set_length(Lmodel, false);
        size_t rowsz = (size_t)(M + 1);
        /* thread-local no-init scratch, reused across pairs: fresh
         * 16 MB allocations per call churn mmap'd pages (kernel
         * zeroing + soft faults); write_row fills k=1..M of rows
         * 1..L and oa_core reads exactly those cells */
        static thread_local Darr pMv, pIv;
        static thread_local Fwd f;
        pMv.alloc((size_t)(L + 1) * rowsz);
        pIv.alloc((size_t)(L + 1) * rowsz);
        std::vector<double> pNv(L + 1, 0.0), pJv(L + 1, 0.0),
            pCv(L + 1, 0.0);
        double *pM = pMv.data();
        double *pI = pIv.data();
        /* ---- the exact posterior_pair unihit computation ---- */
        double tot = unihit_forward(mo, codes, L, &f);
        std::vector<double> bm0(M+1,0.0), bm1(M+1,0.0),
            bi0(M+1,0.0), bi1(M+1,0.0), Dk(M+1,0.0);
        std::vector<double> bNv(L+1,0.0), bCv(L+1,0.0), slv(L+1,0.0);
        double bN = 0.0, bC = mo.move, bE = bC, sl = 0.0;
        bNv[L] = bN; bCv[L] = bC; slv[L] = sl;
        auto write_row = [&](int i, const double *bm_,
                             const double *bi_, double sl_i) {
            double sc = std::exp(f.scale_log[i] + sl_i - tot);
            const double *fm = f.rowM(i);
            const double *fi = f.rowI(i);
            double *oM = &pM[(size_t)i*(M+1)];
            double *oI = &pI[(size_t)i*(M+1)];
            int k = 1;
#ifdef WT_ROWS_AVX512
            __m512d vsc = _mm512_set1_pd(sc);
            for (; k + 7 <= M; k += 8) {
                _mm512_storeu_pd(oM + k, _mm512_mul_pd(_mm512_mul_pd(
                    _mm512_loadu_pd(fm + k),
                    _mm512_loadu_pd(bm_ + k)), vsc));
                _mm512_storeu_pd(oI + k, _mm512_mul_pd(_mm512_mul_pd(
                    _mm512_loadu_pd(fi + k),
                    _mm512_loadu_pd(bi_ + k)), vsc));
            }
#endif
            for (; k <= M; k++) {
                oM[k] = fm[k]*bm_[k]*sc;
                oI[k] = fi[k]*bi_[k]*sc;
            }
        };
        {
            Dk[M] = bE;
            for (int k = M - 1; k >= 1; k--)
                Dk[k] = Dk[k + 1] * mo.dd[k] + bE;
            double *bm_ = bm1.data();
            bm_[0] = 0.0;
            for (int k = 1; k <= M; k++)
                bm_[k] = bE + (k < M ? Dk[k + 1] * mo.md[k] : 0.0);
            if (L >= 1) write_row(L, bm_, bi1.data(), sl);
        }
        for (int i = L - 1; i >= 0; i--) {
            const double *Mn = ((L - i) & 1) ? bm1.data() : bm0.data();
            const double *In = ((L - i) & 1) ? bi1.data() : bi0.data();
            double *bm_ = ((L - i) & 1) ? bm0.data() : bm1.data();
            double *bi_ = ((L - i) & 1) ? bi0.data() : bi1.data();
            int x = codes[i];
            const double *ex = &mo.emX[(size_t)x * (M + 1)];
            double Bv = row_dot3(mo.bmo.data(), ex, Mn, M);
            bN = bN * mo.loop + Bv * mo.move;
            bC = bC * mo.loop;
            bE = bC;
            row_bck_dchain(Mn, ex, mo.dm.data(), mo.dd.data(), bE,
                           Dk.data(), M);
            double mx = row_bck_mi(Mn, In, ex, mo.mm.data(),
                                   mo.mi.data(), mo.md.data(),
                                   mo.im.data(), mo.ii.data(),
                                   Dk.data(), bE, bm_, bi_, M);
            if (mx > 0.0 && (mx > 1e3 || mx < 1e-3)) {
                double inv = 1.0 / mx;
                row_scale(bm_, inv, M);
                row_scale(bi_, inv, M);
                bN *= inv; bC *= inv; bE *= inv;
                row_scale(Dk.data(), inv, M);
                sl += std::log(mx);
            }
            bNv[i] = bN; bCv[i] = bC; slv[i] = sl;
            if (i >= 1) write_row(i, bm_, bi_, sl);
        }
        for (int i = 1; i <= L; i++) {
            double sc1 = std::exp(f.scale_log[i-1] + slv[i] - tot);
            pNv[i] = f.N[i-1]*mo.loop*bNv[i]*sc1;
            pCv[i] = f.C[i-1]*mo.loop*bCv[i]*sc1;
            pJv[i] = 0.0;
        }
        /* ---- OA fill + trace on the scratch planes ---- */
        rc = oa_core(pM, pI, pNv.data(), pJv.data(), pCv.data(), L, M,
                     du[0], du[1], du[2], du[3], du[4], du[5], du[6],
                     du[7], 0, cols);
        Py_END_ALLOW_THREADS
    }
    if (rc != 0) {
        Py_DECREF(out);
        PyErr_SetString(PyExc_RuntimeError,
                        "OA traceback did not terminate");
        return NULL;
    }
    return (PyObject *)out;
}

/* classify_targets_rows(lens i32[N], mocc2d f32[N,Lp1], ppB2d, ppE2d)
 *
 * Region classification WITHOUT null2/ensembles, for the device-null2
 * gate path: finds each target's p7_domaindef regions from its flank
 * posterior rows and applies the RT3 multidomain split test. Returns
 *   (nreg i32[N], has_multi i8[N], pair_idx i32[R], ei i32[R],
 *    ej i32[R])
 * where (pair_idx, ei, ej) lists the SINGLE-envelope regions of
 * targets with has_multi == 0 — exactly the envelopes whose
 * null2-by-expectation (the gate stage's dominant host cost) can be
 * batched on the accelerator (ops/pallas_null2.py). Targets with any
 * multidomain region keep the full host path (trace ensembles).
 * Row conventions match evaluate_targets_rows. */
static PyObject *classify_targets_rows(PyObject *, PyObject *args) {
    PyObject *olens, *omocc, *oppb, *oppe;
    if (!PyArg_ParseTuple(args, "OOOO", &olens, &omocc, &oppb, &oppe))
        return NULL;
    PyArrayObject *alens = (PyArrayObject *)olens;
    PyArrayObject *ar[3] = {(PyArrayObject *)omocc,
                            (PyArrayObject *)oppb,
                            (PyArrayObject *)oppe};
    if (!PyArray_Check(olens) || PyArray_TYPE(alens) != NPY_INT32 ||
        PyArray_NDIM(alens) != 1 || !PyArray_IS_C_CONTIGUOUS(alens)) {
        PyErr_SetString(PyExc_TypeError, "lens must be i32 1D");
        return NULL;
    }
    npy_intp N = PyArray_DIM(alens, 0), Lp1 = 0;
    for (int r = 0; r < 3; r++) {
        if (!PyArray_Check((PyObject *)ar[r]) ||
            PyArray_TYPE(ar[r]) != NPY_FLOAT32 ||
            PyArray_NDIM(ar[r]) != 2 ||
            !PyArray_IS_C_CONTIGUOUS(ar[r]) ||
            PyArray_DIM(ar[r], 0) != N) {
            PyErr_SetString(PyExc_TypeError,
                            "rows must be f32 2D [N, Lmax+1]");
            return NULL;
        }
        if (r == 0) Lp1 = PyArray_DIM(ar[r], 1);
        else if (PyArray_DIM(ar[r], 1) != Lp1) {
            PyErr_SetString(PyExc_ValueError, "row widths differ");
            return NULL;
        }
    }
    const int32_t *lens = (const int32_t *)PyArray_DATA(alens);
    const float *pm = (const float *)PyArray_DATA(ar[0]);
    const float *pb = (const float *)PyArray_DATA(ar[1]);
    const float *pe = (const float *)PyArray_DATA(ar[2]);
    std::vector<int> nreg(N, 0);
    std::vector<int8_t> hasmulti(N, 0);
    std::vector<int32_t> out_pair, out_i, out_j;
    {
        Py_BEGIN_ALLOW_THREADS
        for (npy_intp n = 0; n < N; n++) {
            int L = lens[n];
            if (L + 1 > Lp1) continue;     /* caller guarantees widths */
            const float *rm = pm + (size_t)n * Lp1;
            const float *rb = pb + (size_t)n * Lp1;
            const float *re = pe + (size_t)n * Lp1;
            std::vector<double> mocc(L + 1, 0.0), dB(L + 1, 0.0),
                dE(L + 1, 0.0);
            for (int i = 1; i <= L; i++) {
                mocc[i] = (double)rm[i];
                dB[i] = (double)rb[i - 1];
                dE[i] = (double)re[i];
            }
            std::vector<Region> regions = find_regions_c(mocc, dB, dE, L);
            nreg[n] = (int)regions.size();
            if (regions.empty()) continue;
            std::vector<double> btot(L + 1, 0.0), etot(L + 1, 0.0);
            for (int i = 1; i <= L; i++) {
                btot[i] = btot[i - 1] + dB[i];
                etot[i] = etot[i - 1] + dE[i];
            }
            size_t mark = out_pair.size();
            for (const Region &rg : regions) {
                float best = 0.0f;
                for (int z = rg.i; z <= rg.j; z++) {
                    float epre = (float)(etot[z] - etot[rg.i - 1]);
                    float bpost = (float)(btot[rg.j] - btot[z - 1]);
                    float v = epre < bpost ? epre : bpost;
                    if (v > best) best = v;
                }
                if (best < 0.20f) {
                    out_pair.push_back((int32_t)n);
                    out_i.push_back(rg.i);
                    out_j.push_back(rg.j);
                } else {
                    hasmulti[n] = 1;
                }
            }
            if (hasmulti[n]) {
                /* whole target goes to the host engine */
                out_pair.resize(mark);
                out_i.resize(mark);
                out_j.resize(mark);
            }
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp nd = N, rd = (npy_intp)out_pair.size();
    PyArrayObject *anreg = (PyArrayObject *)PyArray_SimpleNew(
        1, &nd, NPY_INT32);
    PyArrayObject *amulti = (PyArrayObject *)PyArray_SimpleNew(
        1, &nd, NPY_INT8);
    PyArrayObject *apair = (PyArrayObject *)PyArray_SimpleNew(
        1, &rd, NPY_INT32);
    PyArrayObject *aei = (PyArrayObject *)PyArray_SimpleNew(
        1, &rd, NPY_INT32);
    PyArrayObject *aej = (PyArrayObject *)PyArray_SimpleNew(
        1, &rd, NPY_INT32);
    for (npy_intp n = 0; n < N; n++) {
        ((int32_t *)PyArray_DATA(anreg))[n] = nreg[n];
        ((int8_t *)PyArray_DATA(amulti))[n] = hasmulti[n];
    }
    for (npy_intp r = 0; r < rd; r++) {
        ((int32_t *)PyArray_DATA(apair))[r] = out_pair[r];
        ((int32_t *)PyArray_DATA(aei))[r] = out_i[r];
        ((int32_t *)PyArray_DATA(aej))[r] = out_j[r];
    }
    PyObject *ret = PyTuple_Pack(5, (PyObject *)anreg, (PyObject *)amulti,
                                 (PyObject *)apair, (PyObject *)aei,
                                 (PyObject *)aej);
    Py_DECREF(anreg); Py_DECREF(amulti); Py_DECREF(apair);
    Py_DECREF(aei); Py_DECREF(aej);
    return ret;
}

/* dbg_f32_score(msc, t.., bm, codes i32, Lseq): full-sequence Forward
 * score (nats) from the exact-f32 striped engine — diagnostic for
 * comparing the f32 value stream against the validated f64 engine. */
static PyObject *dbg_f32_score(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    int Lseq;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lseq))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    mo.build_oprof();
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    stoch32::XF xf;
    stoch32::xf_set(&xf, Lseq, mo.oprof->nj);
    stoch32::Fwd32 f;
    stoch32::forward_f32(*mo.oprof, xf, codes, L, &f);
    double totscale = 0.0;
    for (int i = 1; i <= L; i++)
        totscale += std::log((double)f.xmx[(size_t)i * 6 + 5]);
    double xC = (double)f.xmx[(size_t)L * 6 + 4];
    double sc = std::log(xC * (double)xf.move[stoch32::XF_C]) + totscale;
    return PyFloat_FromDouble(sc);
}

/* dbg_f32_forward(msc, t.., bm, codes i32, Lseq): run the exact-f32
 * striped Forward and dump (dp [L+1, Q*12], xmx [L+1, 6]). */
static PyObject *dbg_f32_forward(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    int Lseq;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lseq))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    mo.build_oprof();
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    stoch32::XF xf;
    stoch32::xf_set(&xf, Lseq, mo.oprof->nj);
    stoch32::Fwd32 f;
    stoch32::forward_f32(*mo.oprof, xf, codes, L, &f);
    int Q = f.Q;
    npy_intp ddp[2] = {L + 1, (npy_intp)Q * 12};
    npy_intp dxm[2] = {L + 1, 6};
    PyArrayObject *adp = (PyArrayObject *)PyArray_SimpleNew(2, ddp,
                                                            NPY_FLOAT32);
    PyArrayObject *axm = (PyArrayObject *)PyArray_SimpleNew(2, dxm,
                                                            NPY_FLOAT32);
    if (!adp || !axm) { Py_XDECREF(adp); Py_XDECREF(axm); return NULL; }
    std::memcpy(PyArray_DATA(adp), f.dp.data(),
                f.dp.size() * sizeof(float));
    std::memcpy(PyArray_DATA(axm), f.xmx.data(),
                f.xmx.size() * sizeof(float));
    return Py_BuildValue("NN", adp, axm);
}

/* dbg_exact32(msc, t.., bm, codes i32): single-pair exact-f32 score
 * component dump -> (ok, seq, pre, fwdsc, nullsc, seqbias, sum_score,
 * seqbias2, n2sc f32[L+1], envsc f32[D], domcorr f32[D]) */
static PyObject *dbg_exact32(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOO", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes))
        return NULL;
    PyObject *olist = PyList_New(1);
    Py_INCREF(ocodes);
    PyList_SET_ITEM(olist, 0, ocodes);
    Model mo;
    std::vector<const int32_t *> cptrv;
    std::vector<int> clenv;
    bool okp = parse_model_targets(omsc, ot, olist, &mo, &cptrv, &clenv);
    Py_DECREF(olist);
    if (!okp) return NULL;
    const int32_t *codes = cptrv[0];
    int L = clenv[0];
    mo.prepare(100);
    mo.build_oprof();
    Exact32Dbg dbg;
    g_x32_dbg = &dbg;
    double sb = 0, pb = 0;
    bool ok = exact32_target(mo, codes, L, &sb, &pb);
    g_x32_dbg = nullptr;
    npy_intp dn = L + 1;
    PyArrayObject *an = (PyArrayObject *)PyArray_SimpleNew(1, &dn,
                                                           NPY_FLOAT32);
    std::memcpy(PyArray_DATA(an), dbg.n2sc.empty()
                ? std::vector<float>(L + 1, 0.f).data()
                : dbg.n2sc.data(), (L + 1) * sizeof(float));
    npy_intp dd = (npy_intp)dbg.envsc.size();
    PyArrayObject *ae = (PyArrayObject *)PyArray_SimpleNew(1, &dd,
                                                           NPY_FLOAT32);
    PyArrayObject *ad = (PyArrayObject *)PyArray_SimpleNew(1, &dd,
                                                           NPY_FLOAT32);
    if (dd) {
        std::memcpy(PyArray_DATA(ae), dbg.envsc.data(),
                    dd * sizeof(float));
        std::memcpy(PyArray_DATA(ad), dbg.domcorr.data(),
                    dd * sizeof(float));
    }
    return Py_BuildValue("iddfffffNNN", (int)ok, sb, pb,
                         (double)dbg.fwdsc, (double)dbg.nullsc,
                         (double)dbg.seqbias, (double)dbg.sum_score,
                         (double)dbg.seqbias2, an, ae, ad);
}

/* exact_scores32(msc, t.., bm, codes_list) -> (ok u8[N], seq f64[N],
 * pre f64[N]): the exact-f32 reported-score chain per pair
 * (single-envelope regions only; ok=0 where the f64 path must be
 * used).  Region inputs come from the f64 flank computation exactly
 * like evaluate_target. */
static PyObject *exact_scores32(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *olist;
    int nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &olist, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptrv;
    std::vector<int> clenv;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptrv, &clenv))
        return NULL;
    Py_ssize_t N = (Py_ssize_t)cptrv.size();
    std::vector<uint8_t> okv(N, 0);
    std::vector<double> seqv(N, 0.0), prev_(N, 0.0);
    {
        Py_BEGIN_ALLOW_THREADS
        mo.prepare(100);
        mo.build_oprof();
        int nt = nthreads < 1 ? 1 : nthreads;
        if (nt > 16) nt = 16;
        std::vector<std::thread> threads;
        std::atomic<Py_ssize_t> next(0);
        auto work = [&]() {
            for (;;) {
                Py_ssize_t n = next.fetch_add(1);
                if (n >= N) break;
                const int32_t *codes = cptrv[n];
                int L = clenv[n];
                double sb, pb;
                if (exact32_target(mo, codes, L, &sb, &pb)) {
                    okv[n] = 1;
                    seqv[n] = sb;
                    prev_[n] = pb;
                }
            }
        };
        if (nt == 1) work();
        else {
            for (int t = 0; t < nt; t++) threads.emplace_back(work);
            for (auto &th : threads) th.join();
        }
        Py_END_ALLOW_THREADS
    }
    npy_intp dim = N;
    PyArrayObject *aok = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                            NPY_UINT8);
    PyArrayObject *asq = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                            NPY_FLOAT64);
    PyArrayObject *apr = (PyArrayObject *)PyArray_SimpleNew(1, &dim,
                                                            NPY_FLOAT64);
    if (!aok || !asq || !apr) {
        Py_XDECREF(aok); Py_XDECREF(asq); Py_XDECREF(apr);
        return NULL;
    }
    for (Py_ssize_t n = 0; n < N; n++) {
        ((uint8_t *)PyArray_DATA(aok))[n] = okv[n];
        ((double *)PyArray_DATA(asq))[n] = seqv[n];
        ((double *)PyArray_DATA(apr))[n] = prev_[n];
    }
    return Py_BuildValue("NNN", aok, asq, apr);
}

/* ---- exact_scores32 split at its transcendental functions ------------
 *
 * The print overlay on a card (ops/overlay.py, csrc/overlay.cu) runs
 * exact32_target in three host stages around two launches: the striped
 * tables here; launch A (the full-sequence multihit Forward and Backward,
 * stream mode) -> exact32_regions (domain decoding, the region scan,
 * fwdsc); launch B (per single-envelope region, the unihit Forward,
 * Backward, posterior decoding and null2 by expectation) ->
 * exact32_finish (n2sc, domcorr, envsc and the score assembly). Every
 * libm call (x_log, x_logf, p7_flogsum) stays in these host stages.
 * exact32_intermediates computes both launches' outputs on the host with
 * the stoch32 engine, so the split can be held against exact_scores32
 * without a card. */

/* f32 Forward score from a Forward's xmx rows [L+1][6]: totscale
 * replayed from the SCALE column in row order (a rescaled row stores
 * its pre-rescale xE > 1e4, every other row 1.0), as forward_f32 sums it */
static float fwdsc_from_xmx(const float *xmx, int L, float moveC) {
    float totscale = 0.0f;
    for (int i = 1; i <= L; i++) {
        float s = xmx[(size_t)i * 6 + stoch32::XMX_SCALE];
        if (s != 1.0f)
            totscale = (float)((double)totscale + stoch32::x_log((double)s));
    }
    float xC = xmx[(size_t)L * 6 + stoch32::XMX_C];
    return (float)(stoch32::x_log((double)xC * (double)moveC)
                   + (double)totscale);
}

static PyArrayObject *new_f32(npy_intp n) {
    return (PyArrayObject *)PyArray_ZEROS(1, &n, NPY_FLOAT32, 0);
}
static PyArrayObject *new_i32(npy_intp n) {
    return (PyArrayObject *)PyArray_ZEROS(1, &n, NPY_INT32, 0);
}

static bool get1d(PyObject *o, int type, npy_intp n, const void **p,
                  const char *what) {
    PyArrayObject *a = (PyArrayObject *)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != type ||
        PyArray_NDIM(a) != 1 || !PyArray_IS_C_CONTIGUOUS(a) ||
        (n >= 0 && PyArray_DIM(a, 0) != n)) {
        PyErr_Format(PyExc_TypeError, "%s: wrong dtype, shape or layout",
                     what);
        return false;
    }
    *p = PyArray_DATA(a);
    return true;
}

/* exact32_tables(msc, t.., bm) -> (Q, nj, rfv f32[ncodes*Q*4],
 * tfv f32[8*Q*4]): the striped profile exact_scores32 builds */
static PyObject *exact32_tables(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8];
    if (!PyArg_ParseTuple(args, "OOOOOOOOO", &omsc, &ot[0], &ot[1], &ot[2],
                          &ot[3], &ot[4], &ot[5], &ot[6], &ot[7]))
        return NULL;
    PyObject *none = PyList_New(0);
    Model mo;
    std::vector<const int32_t *> cptrv;
    std::vector<int> clenv;
    bool okp = parse_model_targets(omsc, ot, none, &mo, &cptrv, &clenv);
    Py_DECREF(none);
    if (!okp) return NULL;
    Py_BEGIN_ALLOW_THREADS
    mo.build_oprof();
    Py_END_ALLOW_THREADS
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    const stoch32::OProfile &op = *mo.oprof;
    PyArrayObject *arf = new_f32((npy_intp)op.rfv.size());
    PyArrayObject *atf = new_f32((npy_intp)op.tfv.size());
    if (!arf || !atf) { Py_XDECREF(arf); Py_XDECREF(atf); return NULL; }
    std::memcpy(PyArray_DATA(arf), op.rfv.data(),
                op.rfv.size() * sizeof(float));
    std::memcpy(PyArray_DATA(atf), op.tfv.data(),
                op.tfv.size() * sizeof(float));
    return Py_BuildValue("idNN", op.Q, (double)op.nj, arf, atf);
}

/* exact32_intermediates(msc, t.., bm, codes_list, i0 i32[N], ld i32[N],
 * lseq i32[N], mode, nthreads) -> (xmx_f f32[sum(ld+1)*6], xmx_b (same),
 * flags i32[N], null2 f32[N*Kc]): the outputs of the overlay's launches
 * on the host. Item n runs on codes_list[n][i0 .. i0+ld). mode 0
 * (launch A): multihit xf_set(lseq, nj), Forward then Backward in
 * stream mode; flags bit 0 = the Backward took its own scales. mode 1
 * (launch B): unihit xf_set_unihit(lseq), Forward, Backward,
 * decoding_f32 and null2_by_expectation_f32 (canonical codes, xfactor
 * added); flags bit 1 = decoding refused (null2 left 0). */
static PyObject *exact32_intermediates(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *olist, *oi0, *old, *ols;
    int mode, nthreads;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOii", &omsc, &ot[0], &ot[1],
                          &ot[2], &ot[3], &ot[4], &ot[5], &ot[6], &ot[7],
                          &olist, &oi0, &old, &ols, &mode, &nthreads))
        return NULL;
    Model mo;
    std::vector<const int32_t *> cptrv;
    std::vector<int> clenv;
    if (!parse_model_targets(omsc, ot, olist, &mo, &cptrv, &clenv))
        return NULL;
    npy_intp N = (npy_intp)cptrv.size();
    const int32_t *i0, *ld, *ls;
    if (!get1d(oi0, NPY_INT32, N, (const void **)&i0, "i0") ||
        !get1d(old, NPY_INT32, N, (const void **)&ld, "ld") ||
        !get1d(ols, NPY_INT32, N, (const void **)&ls, "lseq"))
        return NULL;
    std::vector<size_t> off(N + 1, 0);
    for (npy_intp n = 0; n < N; n++) {
        if (ld[n] < 1 || i0[n] < 0 || i0[n] + ld[n] > clenv[n]) {
            PyErr_SetString(PyExc_ValueError, "item outside its codes");
            return NULL;
        }
        off[n + 1] = off[n] + (size_t)(ld[n] + 1) * 6;
    }
    mo.build_oprof();
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    const stoch32::OProfile &om = *mo.oprof;
    int Kc = g_alpha_kc;
    PyArrayObject *axf = new_f32((npy_intp)off[N]);
    PyArrayObject *axb = new_f32((npy_intp)off[N]);
    PyArrayObject *afl = new_i32(N);
    PyArrayObject *an2 = new_f32(N * Kc);
    if (!axf || !axb || !afl || !an2) {
        Py_XDECREF(axf); Py_XDECREF(axb); Py_XDECREF(afl); Py_XDECREF(an2);
        return NULL;
    }
    float *xf_out = (float *)PyArray_DATA(axf);
    float *xb_out = (float *)PyArray_DATA(axb);
    int32_t *fl = (int32_t *)PyArray_DATA(afl);
    float *n2 = (float *)PyArray_DATA(an2);
    Py_BEGIN_ALLOW_THREADS
    std::atomic<npy_intp> next(0);
    auto work = [&]() {
        stoch32::Fwd32 f, b, pp;
        std::vector<float> null2(om.ncodes, 0.0f);
        for (;;) {
            npy_intp n = next.fetch_add(1);
            if (n >= N) break;
            const int32_t *codes = cptrv[n] + i0[n];
            int L = ld[n];
            stoch32::XF xf;
            int flags = 0;
            if (mode == 0) {
                stoch32::xf_set(&xf, ls[n], om.nj);
                stoch32::forward_f32(om, xf, codes, L, &f, true);
                stoch32::backward_f32(om, xf, codes, L, f, &b, true);
            } else {
                stoch32::xf_set_unihit(&xf, ls[n]);
                stoch32::forward_f32(om, xf, codes, L, &f);
                stoch32::backward_f32(om, xf, codes, L, f, &b);
                if (!stoch32::decoding_f32(om, xf, f, b, &pp)) {
                    flags |= 2;
                } else {
                    stoch32::null2_by_expectation_f32(
                        om, xf, &pp, g_alpha_expand.data(), Kc,
                        null2.data());
                    std::memcpy(n2 + (size_t)n * Kc, null2.data(),
                                (size_t)Kc * sizeof(float));
                }
            }
            if (b.own_scales) flags |= 1;
            fl[n] = flags;
            std::memcpy(xf_out + off[n], f.xmx.data(),
                        f.xmx.size() * sizeof(float));
            std::memcpy(xb_out + off[n], b.xmx.data(),
                        b.xmx.size() * sizeof(float));
        }
    };
    int nt = nthreads < 1 ? 1 : (nthreads > 16 ? 16 : nthreads);
    if (nt == 1) work();
    else {
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; t++) threads.emplace_back(work);
        for (auto &th : threads) th.join();
    }
    Py_END_ALLOW_THREADS
    return Py_BuildValue("NNNN", axf, axb, afl, an2);
}

/* exact32_regions(xmx_f, xmx_b, flags i32[N], L i32[N], nj f32[N]) ->
 * (status i32[N], fwdsc f32[N], reg_pair i32[R], reg_i i32[R],
 * reg_j i32[R]): launch A's rows -> exact32_target's domain decoding,
 * region scan and best < 0.20 test. status 0: every region is a single
 * envelope (listed, in position order); 1: no region (ok = 0); 2: a
 * multidomain region (the whole pair goes to exact_scores32); 3: the
 * Backward took its own scales or decoding overflowed (ok = 0, as
 * exact32_target refuses it). xmx rows of pair n start at
 * sum(L[:n] + 1) * 6. */
static PyObject *exact32_regions(PyObject *, PyObject *args) {
    PyObject *oxf, *oxb, *ofl, *oL, *onj;
    if (!PyArg_ParseTuple(args, "OOOOO", &oxf, &oxb, &ofl, &oL, &onj))
        return NULL;
    const int32_t *fl, *Ls;
    const float *njs, *xf, *xb;
    if (!get1d(oL, NPY_INT32, -1, (const void **)&Ls, "L")) return NULL;
    npy_intp N = PyArray_DIM((PyArrayObject *)oL, 0);
    size_t tot = 0;
    for (npy_intp n = 0; n < N; n++) tot += (size_t)(Ls[n] + 1) * 6;
    if (!get1d(ofl, NPY_INT32, N, (const void **)&fl, "flags") ||
        !get1d(onj, NPY_FLOAT32, N, (const void **)&njs, "nj") ||
        !get1d(oxf, NPY_FLOAT32, (npy_intp)tot, (const void **)&xf,
               "xmx_f") ||
        !get1d(oxb, NPY_FLOAT32, (npy_intp)tot, (const void **)&xb,
               "xmx_b"))
        return NULL;
    std::vector<int32_t> status(N, 0);
    std::vector<float> fwdsc(N, 0.0f);
    std::vector<int32_t> rp, ri, rj;
    Py_BEGIN_ALLOW_THREADS
    stoch32::Fwd32 f, b;
    std::vector<float> mocc, btot, etot;
    size_t off = 0;
    for (npy_intp n = 0; n < N; n++) {
        int L = Ls[n];
        size_t len = (size_t)(L + 1) * 6;
        stoch32::XF xff;
        stoch32::xf_set(&xff, L, njs[n]);
        f.L = b.L = L;
        f.xmx.assign(xf + off, xf + off + len);
        b.xmx.assign(xb + off, xb + off + len);
        b.own_scales = (fl[n] & 1) != 0;
        off += len;
        fwdsc[n] = fwdsc_from_xmx(f.xmx.data(), L, xff.move[stoch32::XF_C]);
        mocc.assign(L + 1, 0.0f);
        btot.assign(L + 1, 0.0f);
        etot.assign(L + 1, 0.0f);
        if (!stoch32::domain_decoding_f32(xff, f, b, mocc.data(),
                                          btot.data(), etot.data())) {
            status[n] = 3;
            continue;
        }
        std::vector<Region> regions = find_regions_f32(
            mocc.data(), btot.data(), etot.data(), L);
        if (regions.empty()) {
            status[n] = 1;
            continue;
        }
        size_t first = rp.size();
        for (const Region &rg : regions) {
            float best = 0.0f;
            for (int z = rg.i; z <= rg.j; z++) {
                float epre = etot[z] - etot[rg.i - 1];
                float bpost = btot[rg.j] - btot[z - 1];
                float v = epre < bpost ? epre : bpost;
                if (v > best) best = v;
            }
            if (!(best < 0.20f)) {
                status[n] = 2;
                break;
            }
            rp.push_back((int32_t)n);
            ri.push_back(rg.i);
            rj.push_back(rg.j);
        }
        if (status[n] == 2) {
            rp.resize(first); ri.resize(first); rj.resize(first);
        }
    }
    Py_END_ALLOW_THREADS
    npy_intp R = (npy_intp)rp.size();
    PyArrayObject *ast = new_i32(N), *afw = new_f32(N);
    PyArrayObject *arp = new_i32(R), *ari = new_i32(R), *arj = new_i32(R);
    if (!ast || !afw || !arp || !ari || !arj) {
        Py_XDECREF(ast); Py_XDECREF(afw); Py_XDECREF(arp);
        Py_XDECREF(ari); Py_XDECREF(arj);
        return NULL;
    }
    std::memcpy(PyArray_DATA(ast), status.data(), N * sizeof(int32_t));
    std::memcpy(PyArray_DATA(afw), fwdsc.data(), N * sizeof(float));
    if (R) {
        std::memcpy(PyArray_DATA(arp), rp.data(), R * sizeof(int32_t));
        std::memcpy(PyArray_DATA(ari), ri.data(), R * sizeof(int32_t));
        std::memcpy(PyArray_DATA(arj), rj.data(), R * sizeof(int32_t));
    }
    return Py_BuildValue("NNNNN", ast, afw, arp, ari, arj);
}

/* exact32_finish(codes_list, fwdsc f32[P], env_pair i32[E], env_i,
 * env_j, env_xmx f32[sum(Ld+1)*6], env_flags i32[E], env_null2
 * f32[E*Kc]) -> (ok u8[P], seq f64[P], pre f64[P]): launch B's outputs
 * -> rescore_isolated_f32's n2sc, domcorr and envsc, then
 * exact32_target's score assembly, for pairs whose regions are all
 * single envelopes (each pair's envelopes consecutive, in position
 * order; a pair with a refused envelope gets ok = 0). */
static PyObject *exact32_finish(PyObject *, PyObject *args) {
    PyObject *olist, *ofw, *oep, *oei, *oej, *oex, *oef, *oen;
    if (!PyArg_ParseTuple(args, "OOOOOOOO", &olist, &ofw, &oep, &oei, &oej,
                          &oex, &oef, &oen))
        return NULL;
    if (!PyList_Check(olist)) {
        PyErr_SetString(PyExc_TypeError, "codes_list must be a list");
        return NULL;
    }
    npy_intp P = PyList_GET_SIZE(olist);
    std::vector<const int32_t *> cptr(P);
    std::vector<int> clen(P);
    for (npy_intp n = 0; n < P; n++) {
        const void *p;
        if (!get1d(PyList_GET_ITEM(olist, n), NPY_INT32, -1, &p, "codes"))
            return NULL;
        cptr[n] = (const int32_t *)p;
        clen[n] = (int)PyArray_DIM((PyArrayObject *)PyList_GET_ITEM(olist,
                                                                     n), 0);
        for (int i = 0; i < clen[n]; i++)
            if (cptr[n][i] < 0 || cptr[n][i] >= g_alpha_ncodes) {
                PyErr_SetString(PyExc_ValueError, "code out of range");
                return NULL;
            }
    }
    const float *fw, *ex, *en;
    const int32_t *ep, *ei, *ej, *ef;
    if (!get1d(oep, NPY_INT32, -1, (const void **)&ep, "env_pair"))
        return NULL;
    npy_intp E = PyArray_DIM((PyArrayObject *)oep, 0);
    int Kc = g_alpha_kc, ncodes = g_alpha_ncodes;
    if (!get1d(ofw, NPY_FLOAT32, P, (const void **)&fw, "fwdsc") ||
        !get1d(oei, NPY_INT32, E, (const void **)&ei, "env_i") ||
        !get1d(oej, NPY_INT32, E, (const void **)&ej, "env_j") ||
        !get1d(oef, NPY_INT32, E, (const void **)&ef, "env_flags") ||
        !get1d(oen, NPY_FLOAT32, E * Kc, (const void **)&en, "env_null2"))
        return NULL;
    size_t tot = 0;
    for (npy_intp e = 0; e < E; e++) {
        if (ep[e] < 0 || ep[e] >= P || ei[e] < 1 || ej[e] < ei[e] ||
            ej[e] > clen[ep[e]] || (e && ep[e] < ep[e - 1])) {
            PyErr_SetString(PyExc_ValueError, "envelope outside its pair");
            return NULL;
        }
        tot += (size_t)(ej[e] - ei[e] + 2) * 6;
    }
    if (!get1d(oex, NPY_FLOAT32, (npy_intp)tot, (const void **)&ex,
               "env_xmx"))
        return NULL;
    std::vector<uint8_t> okv(P, 0);
    std::vector<double> seqv(P, 0.0), prev_(P, 0.0);
    Py_BEGIN_ALLOW_THREADS
    std::vector<Dom32> doms;
    std::vector<float> n2sc, null2(ncodes, 0.0f);
    npy_intp e = 0;
    size_t xoff = 0;
    for (npy_intp n = 0; n < P; n++) {
        const int32_t *codes = cptr[n];
        int L = clen[n];
        stoch32::XF xfu;
        stoch32::xf_set_unihit(&xfu, L);
        n2sc.assign(L + 1, 0.0f);
        doms.clear();
        bool ok = true;
        for (; e < E && ep[e] == n; e++) {
            int i = ei[e], j = ej[e], Ld = j - i + 1;
            const float *xmx = ex + xoff;
            xoff += (size_t)(Ld + 1) * 6;
            if (!ok || (ef[e] & 2)) { ok = false; continue; }
            std::memcpy(null2.data(), en + (size_t)e * Kc,
                        (size_t)Kc * sizeof(float));
            null2_degenerate_f32(null2.data());
            float domcorr = 0.0f;
            for (int pos = i; pos <= j; pos++)
                n2sc[pos] = stoch32::x_logf(null2[codes[pos - 1]]);
            for (int pos = i; pos <= j; pos++) domcorr += n2sc[pos];
            float envsc = fwdsc_from_xmx(xmx, Ld, xfu.move[stoch32::XF_C]);
            doms.push_back({envsc, domcorr, i, j});
        }
        if (!ok) continue;
        okv[n] = 1;
        assemble32(fw[n], L, n2sc, doms, &seqv[n], &prev_[n], nullptr);
    }
    Py_END_ALLOW_THREADS
    npy_intp dim = P;
    PyArrayObject *aok = (PyArrayObject *)PyArray_ZEROS(1, &dim, NPY_UINT8,
                                                        0);
    PyArrayObject *asq = (PyArrayObject *)PyArray_ZEROS(1, &dim,
                                                        NPY_FLOAT64, 0);
    PyArrayObject *apr = (PyArrayObject *)PyArray_ZEROS(1, &dim,
                                                        NPY_FLOAT64, 0);
    if (!aok || !asq || !apr) {
        Py_XDECREF(aok); Py_XDECREF(asq); Py_XDECREF(apr);
        return NULL;
    }
    if (P) {
        std::memcpy(PyArray_DATA(aok), okv.data(), P);
        std::memcpy(PyArray_DATA(asq), seqv.data(), P * sizeof(double));
        std::memcpy(PyArray_DATA(apr), prev_.data(), P * sizeof(double));
    }
    return Py_BuildValue("NNN", aok, asq, apr);
}

/* dbg_f32_ensemble(msc, t.., bm, codes i32, Lseq, seed, nsamples):
 * run the exact-f32 region ensemble and dump every sampled segment as
 * (sample, i, j, k, m) i32 rows. */
static PyObject *dbg_f32_ensemble(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    int Lseq, seed, nsamples;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOiii", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lseq, &seed,
                          &nsamples))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    mo.build_oprof();
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    stoch32::XF xf;
    stoch32::xf_set(&xf, Lseq, mo.oprof->nj);
    stoch32::Fwd32 f;
    stoch32::forward_f32(*mo.oprof, xf, codes, L, &f);
    EselRng rng((uint32_t)seed);
    std::vector<Seg> all;
    std::vector<Seg> tsegs;
    for (int t = 0; t < nsamples; t++) {
        tsegs.clear();
        stoch32::sample_trace_f32(rng, *mo.oprof, xf, f, t, &tsegs,
                                  (std::vector<TraceStep> *)nullptr);
        for (auto &s : tsegs) all.push_back(s);
    }
    npy_intp dims[2] = {(npy_intp)all.size(), 5};
    PyArrayObject *arr = (PyArrayObject *)PyArray_SimpleNew(2, dims,
                                                            NPY_INT32);
    if (!arr) return NULL;
    int32_t *p = (int32_t *)PyArray_DATA(arr);
    for (size_t n = 0; n < all.size(); n++) {
        p[n * 5 + 0] = all[n].t;
        p[n * 5 + 1] = all[n].i;
        p[n * 5 + 2] = all[n].j;
        p[n * 5 + 3] = all[n].k;
        p[n * 5 + 4] = all[n].m;
    }
    return (PyObject *)arr;
}

/* dbg_f32_backward(msc, t.., bm, codes i32, Lseq): run the exact-f32
 * striped Forward+Backward and dump the BACKWARD (dp, xmx). */
static PyObject *dbg_f32_backward(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    int Lseq;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOi", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes, &Lseq))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    mo.build_oprof();
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    stoch32::XF xf;
    stoch32::xf_set(&xf, Lseq, mo.oprof->nj);
    stoch32::Fwd32 f, b;
    stoch32::forward_f32(*mo.oprof, xf, codes, L, &f);
    stoch32::backward_f32(*mo.oprof, xf, codes, L, f, &b);
    int Q = b.Q;
    npy_intp ddp[2] = {L + 1, (npy_intp)Q * 12};
    npy_intp dxm[2] = {L + 1, 6};
    PyArrayObject *adp = (PyArrayObject *)PyArray_SimpleNew(2, ddp,
                                                            NPY_FLOAT32);
    PyArrayObject *axm = (PyArrayObject *)PyArray_SimpleNew(2, dxm,
                                                            NPY_FLOAT32);
    if (!adp || !axm) { Py_XDECREF(adp); Py_XDECREF(axm); return NULL; }
    std::memcpy(PyArray_DATA(adp), b.dp.data(),
                b.dp.size() * sizeof(float));
    std::memcpy(PyArray_DATA(axm), b.xmx.data(),
                b.xmx.size() * sizeof(float));
    return Py_BuildValue("NN", adp, axm);
}

/* dbg_f32_decode_rows(msc, t.., bm, codes i32): exact-f32
 * Forward+Backward+DomainDecoding -> (mocc, btot, etot) f32[L+1]. */
static PyObject *dbg_f32_decode_rows(PyObject *, PyObject *args) {
    PyObject *omsc, *ot[8], *ocodes;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOO", &omsc,
                          &ot[0], &ot[1], &ot[2], &ot[3], &ot[4], &ot[5],
                          &ot[6], &ot[7], &ocodes))
        return NULL;
    PyArrayObject *amsc = (PyArrayObject *)omsc;
    Model mo;
    mo.M = (int)PyArray_DIM(amsc, 0) - 1;
    mo.K = (int)PyArray_DIM(amsc, 1);
    mo.msc = (const double *)PyArray_DATA(amsc);
    const double *tp[8];
    npy_intp tn;
    for (int i = 0; i < 8; i++) {
        if (!get1d_f64(ot[i], &tp[i], &tn)) return NULL;
    }
    mo.t_mm = tp[0]; mo.t_mi = tp[1]; mo.t_md = tp[2]; mo.t_im = tp[3];
    mo.t_ii = tp[4]; mo.t_dm = tp[5]; mo.t_dd = tp[6]; mo.bm = tp[7];
    PyArrayObject *ac = (PyArrayObject *)ocodes;
    const int32_t *codes = (const int32_t *)PyArray_DATA(ac);
    int L = (int)PyArray_DIM(ac, 0);
    mo.build_oprof();
    if (!mo.oprof) {
        PyErr_SetString(PyExc_RuntimeError, "alphabet not set");
        return NULL;
    }
    stoch32::XF xf;
    stoch32::xf_set(&xf, L, mo.oprof->nj);
    stoch32::Fwd32 f, b;
    stoch32::forward_f32(*mo.oprof, xf, codes, L, &f);
    stoch32::backward_f32(*mo.oprof, xf, codes, L, f, &b);
    npy_intp dn = L + 1;
    PyArrayObject *am = (PyArrayObject *)PyArray_SimpleNew(1, &dn,
                                                           NPY_FLOAT32);
    PyArrayObject *ab = (PyArrayObject *)PyArray_SimpleNew(1, &dn,
                                                           NPY_FLOAT32);
    PyArrayObject *ae = (PyArrayObject *)PyArray_SimpleNew(1, &dn,
                                                           NPY_FLOAT32);
    if (!am || !ab || !ae) {
        Py_XDECREF(am); Py_XDECREF(ab); Py_XDECREF(ae);
        return NULL;
    }
    bool ok = stoch32::domain_decoding_f32(
        xf, f, b, (float *)PyArray_DATA(am), (float *)PyArray_DATA(ab),
        (float *)PyArray_DATA(ae));
    if (!ok) {
        Py_DECREF(am); Py_DECREF(ab); Py_DECREF(ae);
        PyErr_SetString(PyExc_RuntimeError, "decoding failed");
        return NULL;
    }
    return Py_BuildValue("NNN", am, ab, ae);
}

/* format_nats_rows(probs f64 2D, sep str): HMMER text formatting of a
 * probability block — each row becomes "  "-joined "%.5f" of -log(p)
 * ("*" for p == 0).  Native because the .hmm writer's per-element
 * Python formatting dominated artifact-writing time (~3.6 s for the
 * example ensemble). */
static PyObject *format_nats_rows(PyObject *, PyObject *args) {
    PyObject *oarr;
    const char *sep;
    if (!PyArg_ParseTuple(args, "Os", &oarr, &sep))
        return NULL;
    PyArrayObject *a = (PyArrayObject *)oarr;
    if (!PyArray_Check(oarr) || PyArray_TYPE(a) != NPY_FLOAT64 ||
        PyArray_NDIM(a) != 2 || !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_TypeError, "probs must be f64 2D C-contig");
        return NULL;
    }
    npy_intp N = PyArray_DIM(a, 0), K = PyArray_DIM(a, 1);
    const double *p = (const double *)PyArray_DATA(a);
    size_t seplen = strlen(sep);
    PyObject *out = PyList_New(N);
    if (!out) return NULL;
    std::vector<char> buf;
    buf.reserve((size_t)K * 12 + 16);
    char num[32];
    for (npy_intp i = 0; i < N; i++) {
        buf.clear();
        for (npy_intp k = 0; k < K; k++) {
            if (k) buf.insert(buf.end(), sep, sep + seplen);
            double v = p[i * K + k];
            if (v == 0.0) {
                buf.push_back('*');
            } else {
                double nats = -std::log(v);
                if (nats == 0.0) nats = 0.0;   /* -0.0 -> 0.0 */
                int n = snprintf(num, sizeof num, "%.5f", nats);
                buf.insert(buf.end(), num, num + n);
            }
        }
        PyObject *s = PyUnicode_FromStringAndSize(buf.data(),
                                                  (Py_ssize_t)buf.size());
        if (!s) { Py_DECREF(out); return NULL; }
        PyList_SET_ITEM(out, i, s);
    }
    return out;
}

/* set_icc_libm(expf_addr, logf_addr, log_addr, svml_logf4_addr): install
 * the oracle binary's own libm entry points (mmapped in-process by
 * witch_tpu/native/icc_libm.py) for the f32 profile-build chain.  Pass
 * zeros to reset to glibc. */
static PyObject *set_icc_libm(PyObject *, PyObject *args) {
    unsigned long long a_expf, a_logf, a_log, a_svml;
    if (!PyArg_ParseTuple(args, "KKKK", &a_expf, &a_logf, &a_log,
                          &a_svml))
        return NULL;
    stoch32::g_icc.expf_ = (float (*)(float))a_expf;
    stoch32::g_icc.logf_ = (float (*)(float))a_logf;
    stoch32::g_icc.log_ = (double (*)(double))a_log;
    stoch32::g_icc.svml_logf4_ = (void *)a_svml;
    Py_RETURN_TRUE;
}

/* set_alphabet(expand f64 [num_codes, Kc], bg f64 [Kc]): store the
 * degeneracy/background tables that enable the exact-f32 trace path.
 * Call once (per alphabet) before the evaluate_* entry points; honored
 * unless WITCH_TPU_F32TRACE=0. */
static PyObject *set_alphabet(PyObject *, PyObject *args) {
    PyObject *oexp, *obg;
    if (!PyArg_ParseTuple(args, "OO", &oexp, &obg)) return NULL;
    const char *off = getenv("WITCH_TPU_F32TRACE");
    if (off && off[0] == '0') Py_RETURN_FALSE;
    PyArrayObject *ae = (PyArrayObject *)oexp;
    PyArrayObject *ab = (PyArrayObject *)obg;
    if (!PyArray_Check(oexp) || PyArray_TYPE(ae) != NPY_FLOAT64 ||
        PyArray_NDIM(ae) != 2 || !PyArray_IS_C_CONTIGUOUS(ae) ||
        !PyArray_Check(obg) || PyArray_TYPE(ab) != NPY_FLOAT64 ||
        PyArray_NDIM(ab) != 1 || !PyArray_IS_C_CONTIGUOUS(ab)) {
        PyErr_SetString(PyExc_TypeError,
                        "expand must be f64 2D, bg f64 1D");
        return NULL;
    }
    int nc = (int)PyArray_DIM(ae, 0);
    int kc = (int)PyArray_DIM(ae, 1);
    if ((int)PyArray_DIM(ab, 0) != kc) {
        PyErr_SetString(PyExc_ValueError, "bg length != expand cols");
        return NULL;
    }
    const double *pe = (const double *)PyArray_DATA(ae);
    const double *pb = (const double *)PyArray_DATA(ab);
    g_alpha_expand.assign(pe, pe + (size_t)nc * kc);
    g_alpha_bg.assign(pb, pb + kc);
    g_alpha_ncodes = nc;
    g_alpha_kc = kc;
    Py_RETURN_TRUE;
}

static PyMethodDef methods[] = {
    {"dbg_f32_score", dbg_f32_score, METH_VARARGS,
     "diagnostic: exact-f32 striped Forward score (nats)"},
    {"dbg_exact32", dbg_exact32, METH_VARARGS,
     "diagnostic: exact-f32 score components for one pair"},
    {"exact_scores32", exact_scores32, METH_VARARGS,
     "exact-f32 reported scores (single-envelope pairs) -> "
     "(ok, seq_bits, pre_bits)"},
    {"exact32_tables", exact32_tables, METH_VARARGS,
     "exact_scores32's striped profile -> (Q, nj, rfv, tfv)"},
    {"exact32_intermediates", exact32_intermediates, METH_VARARGS,
     "the print overlay's launch A (mode 0) or B (mode 1) outputs on the "
     "host -> (xmx_f, xmx_b, flags, null2)"},
    {"exact32_regions", exact32_regions, METH_VARARGS,
     "launch A rows -> (status, fwdsc, reg_pair, reg_i, reg_j)"},
    {"exact32_finish", exact32_finish, METH_VARARGS,
     "launch B outputs -> (ok, seq_bits, pre_bits)"},
    {"dbg_f32_ensemble", dbg_f32_ensemble, METH_VARARGS,
     "diagnostic: exact-f32 region ensemble segment dump"},
    {"dbg_f32_backward", dbg_f32_backward, METH_VARARGS,
     "diagnostic: exact-f32 striped Backward matrix dump"},
    {"dbg_f32_forward", dbg_f32_forward, METH_VARARGS,
     "diagnostic: exact-f32 striped Forward matrix dump"},
    {"dbg_f32_decode_rows", dbg_f32_decode_rows, METH_VARARGS,
     "diagnostic: exact-f32 domain-decoding mocc/btot/etot rows"},
    {"format_nats_rows", format_nats_rows, METH_VARARGS,
     "HMMER text formatting of a probability block -> list of str"},
    {"set_icc_libm", set_icc_libm, METH_VARARGS,
     "install oracle-binary libm entry points (addresses) for the "
     "exact-f32 profile chain"},
    {"set_alphabet", set_alphabet, METH_VARARGS,
     "enable the exact-f32 trace path: (expand [num_codes,Kc] f64, "
     "bg [Kc] f64) -> bool"},
    {"classify_targets_rows", classify_targets_rows, METH_VARARGS,
     "regions + multidomain split from flank rows -> "
     "(nreg, has_multi, pair_idx, ei, ej)"},
    {"ensemble_region", ensemble_region, METH_VARARGS,
     "stochastic trace ensemble for one region -> (clusters, n2acc)"},
    {"evaluate_targets_rows", evaluate_targets_rows, METH_VARARGS,
     "domain definition from caller-provided flank posterior rows"},
    {"evaluate_targets", evaluate_targets, METH_VARARGS,
     "one model vs many targets -> (nregions, nenvelopes, seqbias, fwd,"
     " sum_env, sum_bias, ld)"},
    {"forward_targets", forward_targets, METH_VARARGS,
     "one model vs many targets, Forward-only -> fwd nats f64[N]"},
    {"forward_targets_simd", forward_targets_simd, METH_VARARGS,
     "AVX-512 lane-parallel f32 pre-ranking Forward -> fwd nats f64[N]"},
    {"flank_targets_simd", flank_targets_simd, METH_VARARGS,
     "AVX-512 lane-parallel gate flank rows -> (fwd, mocc, ppB, ppE)"},
    {"forward_targets_exact", forward_targets_exact, METH_VARARGS,
     "lane-parallel EXACT f64 Forward (8 lanes) -> fwd nats f64[N]"},
    {"posterior_oa_pair", posterior_oa_pair, METH_VARARGS,
     "fused unihit posterior + OA fill/trace -> aligned columns i64[L]"},
    {"posterior_pair", posterior_pair, METH_VARARGS,
     "dense f64 posterior decode of one pair -> (ppM, ppI, ppN, ppJ, ppC)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_domaindef",
                                 "native domaindef engine", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__domaindef(void) {
    import_array();
    return PyModule_Create(&mod);
}
