/* Optimal-accuracy fill + traceback, native host kernel.
 *
 * Exact reimplementation of witch_tpu/hmm/align_ref.py's oa_fill/oa_trace
 * (HMMER generic_optacc semantics: -inf init, FLT_MIN deltas for disallowed
 * transitions, first-max-wins tie order). The heavy posterior matrices come
 * from the TPU; this kernel turns them into a state path ~20x faster than
 * the numpy version, which matters when aligning thousands of
 * (query x HMM) pairs or iterating a backbone alignment.
 *
 * CPython C API + numpy, no external dependencies.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cfloat>
#include <cmath>
#include <cstdlib>
#include <limits>
#include <vector>

static const double NEG = -std::numeric_limits<double>::infinity();
static const double DELTA_OFF = (double)FLT_MIN;

struct View2D {
    const double *p;
    npy_intp rows, cols;
    inline double at(npy_intp i, npy_intp j) const { return p[i * cols + j]; }
};

static bool get2d(PyObject *o, View2D *v) {
    PyArrayObject *a = (PyArrayObject *)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_FLOAT64 ||
        PyArray_NDIM(a) != 2 || !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_TypeError,
                        "expected C-contiguous float64 2D array");
        return false;
    }
    v->p = (const double *)PyArray_DATA(a);
    v->rows = PyArray_DIM(a, 0);
    v->cols = PyArray_DIM(a, 1);
    return true;
}

static bool get1d(PyObject *o, const double **p, npy_intp *n) {
    PyArrayObject *a = (PyArrayObject *)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_FLOAT64 ||
        PyArray_NDIM(a) != 1 || !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_TypeError,
                        "expected C-contiguous float64 1D array");
        return false;
    }
    *p = (const double *)PyArray_DATA(a);
    *n = PyArray_DIM(a, 0);
    return true;
}

static bool get1du8(PyObject *o, const unsigned char **p, npy_intp *n) {
    PyArrayObject *a = (PyArrayObject *)o;
    if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_UINT8 ||
        PyArray_NDIM(a) != 1 || !PyArray_IS_C_CONTIGUOUS(a)) {
        PyErr_SetString(PyExc_TypeError,
                        "expected C-contiguous uint8 1D array");
        return false;
    }
    *p = (const unsigned char *)PyArray_DATA(a);
    *n = PyArray_DIM(a, 0);
    return true;
}

/* oa_align(ppM, ppI, ppN, ppJ, ppC, d_mm, d_mi, d_md, d_im, d_ii,
 *          d_dm, d_dd, d_bm, multihit) -> int64[L] aligned columns
 * pp arrays are [L+1, M+1] / [L+1]; d_* are uint8 [M+1] feasibility flags.
 */
static PyObject *oa_align(PyObject *, PyObject *args) {
    PyObject *oM, *oI, *oN, *oJ, *oC;
    PyObject *odmm, *odmi, *odmd, *odim, *odii, *oddm, *oddd, *odbm;
    int multihit;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOp", &oM, &oI, &oN, &oJ, &oC,
                          &odmm, &odmi, &odmd, &odim, &odii, &oddm, &oddd,
                          &odbm, &multihit))
        return NULL;
    View2D ppM, ppI;
    const double *ppN, *ppJ, *ppC;
    const unsigned char *dmm, *dmi, *dmd, *dim, *dii, *ddm, *ddd, *dbm;
    npy_intp n1, Mp1;
    if (!get2d(oM, &ppM) || !get2d(oI, &ppI)) return NULL;
    const npy_intp L = ppM.rows - 1;
    const npy_intp M = ppM.cols - 1;
    if (ppI.rows != L + 1 || ppI.cols != M + 1) {
        PyErr_SetString(PyExc_ValueError, "ppI shape must match ppM");
        return NULL;
    }
    {
        const double *pp1[3];
        PyObject *o1[3] = {oN, oJ, oC};
        for (int t = 0; t < 3; t++) {
            if (!get1d(o1[t], &pp1[t], &n1)) return NULL;
            if (n1 != L + 1) {
                PyErr_SetString(PyExc_ValueError,
                                "ppN/ppJ/ppC length must be L+1");
                return NULL;
            }
        }
        ppN = pp1[0]; ppJ = pp1[1]; ppC = pp1[2];
        const unsigned char *pu8[8];
        PyObject *ou8[8] = {odmm, odmi, odmd, odim, odii, oddm, oddd, odbm};
        for (int t = 0; t < 8; t++) {
            if (!get1du8(ou8[t], &pu8[t], &Mp1)) return NULL;
            if (Mp1 != M + 1) {
                PyErr_SetString(PyExc_ValueError,
                                "transition flag length must be M+1");
                return NULL;
            }
        }
        dmm = pu8[0]; dmi = pu8[1]; dmd = pu8[2]; dim = pu8[3];
        dii = pu8[4]; ddm = pu8[5]; ddd = pu8[6]; dbm = pu8[7];
    }

    npy_intp dims[1] = {L};
    PyArrayObject *out =
        (PyArrayObject *)PyArray_SimpleNew(1, dims, NPY_INT64);
    if (!out) return NULL;
    npy_int64 *cols = (npy_int64 *)PyArray_DATA(out);
    for (npy_intp i = 0; i < L; i++) cols[i] = -1;

    /* Rolling-row fill with recorded traceback choices: instead of three
     * [L+1, M+1] float64 matrices (re-read by a value-re-deriving
     * traceback), keep two rows of each DP plane and record, per cell,
     * the choice the traceback WOULD make — evaluated with the
     * traceback's exact candidate order and tie rules, on the same
     * values — packed into one u8 plane. ~24 MB of DP traffic per pair
     * becomes ~0.5 MB. Outputs are bit-identical by construction.
     *
     * ptr bits: 0-1 = M-source (0 M, 1 I, 2 D, 3 B);
     *           bit 2 = I-source (0 M, 1 I);
     *           bit 3 = D-source (0 M, 1 D-continue). */
    const size_t rowsz = (size_t)(M + 1);
    std::vector<double> mrow0(rowsz, NEG), mrow1(rowsz, NEG),
        irow0(rowsz, NEG), irow1(rowsz, NEG),
        drow0(rowsz, NEG), drow1(rowsz, NEG);
    std::vector<unsigned char> ptr((size_t)(L + 1) * rowsz, 0);
    std::vector<double> N(L + 1, 0.0), B(L + 1, 0.0), E(L + 1, NEG),
        J(L + 1, NEG), C(L + 1, NEG);
    std::vector<npy_intp> ek(L + 1, 1);    /* E argmax k per row */
    std::vector<unsigned char> ed(L + 1, 0);  /* E came from D */
    auto DEL = [](unsigned char f) { return f ? 1.0 : DELTA_OFF; };

    /* ------------------------------- fill ------------------------------- */
    for (npy_intp i = 1; i <= L; i++) {
        const double *pM = (i & 1) ? mrow0.data() : mrow1.data();
        const double *pI = (i & 1) ? irow0.data() : irow1.data();
        const double *pD = (i & 1) ? drow0.data() : drow1.data();
        double *cM = (i & 1) ? mrow1.data() : mrow0.data();
        double *cI = (i & 1) ? irow1.data() : irow0.data();
        double *cD = (i & 1) ? drow1.data() : drow0.data();
        unsigned char *pt = &ptr[(size_t)i * rowsz];
        cM[0] = NEG; cI[0] = NEG; cD[0] = NEG;
        cD[1] = NEG;
        double emax = NEG;
        npy_intp emax_k = 1;
        unsigned char emax_d = 0;
        const double Bprev = B[i - 1];
        double dacc = NEG; /* running-max delete chain */
        for (npy_intp k = 1; k <= M; k++) {
            const double pm = ppM.at(i, k);
            /* traceback candidate order: M, I, D, B (strict >) */
            const double c0 = DEL(dmm[k - 1]) * pM[k - 1];
            const double c1 = DEL(dim[k - 1]) * pI[k - 1];
            const double c2 = DEL(ddm[k - 1]) * pD[k - 1];
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
                const double a = DEL(dmi[k]) * pM[k];
                const double b = DEL(dii[k]) * pI[k];
                if (!(a >= b)) pb |= 4;        /* I came from I */
                cI[k] = ppI.at(i, k) + (a >= b ? a : b);
            } else {
                cI[k] = NEG;
            }
            if (k >= 2) {
                const double md = DEL(dmd[k - 1]) * cM[k - 1];
                const double dc = DEL(ddd[k - 1]) * cD[k - 1];
                if (!(md >= dc)) pb |= 8;      /* D continues */
                if (md > dacc) dacc = md;
                cD[k] = dacc;
                if (dacc > emax) {
                    emax = dacc; emax_k = k; emax_d = 1;
                }
            }
            if (mval > emax) { emax = mval; emax_k = k; emax_d = 0; }
            pt[k] = pb;
        }
        /* the traceback's E scan walks kk ascending comparing M then D
         * per kk with strict > — re-derive its pick on the same values */
        {
            double best = NEG;
            npy_intp kmax = 1;
            unsigned char dmx = 0;
            for (npy_intp kk = 1; kk <= M; kk++) {
                if (cM[kk] > best) { best = cM[kk]; kmax = kk; dmx = 0; }
                if (cD[kk] > best) { best = cD[kk]; kmax = kk; dmx = 1; }
            }
            ek[i] = kmax;
            ed[i] = dmx;
            (void)emax_k; (void)emax_d;
        }
        E[i] = emax;
        const double jloop = (J[i - 1] == NEG) ? NEG : J[i - 1] + ppJ[i];
        J[i] = multihit ? (jloop > emax ? jloop : emax)
                        : jloop;
        const double cloop = (std::isfinite(C[i - 1]))
                                 ? C[i - 1] + ppC[i]
                                 : NEG;
        C[i] = cloop > emax ? cloop : emax;
        N[i] = N[i - 1] + ppN[i];
        if (multihit && J[i] > N[i])
            B[i] = J[i];
        else
            B[i] = N[i];
    }

    /* ---------------------------- traceback ---------------------------- */
    npy_intp i = L, k = 0;
    enum { S_C, S_J, S_E, S_M, S_I, S_D, S_B, S_N } st = S_C;
    long max_steps = 4 * (long)(L + M) + 16;
    long steps = 0;
    while (!(st == S_N && i == 0)) {
        if (++steps > max_steps || i < 0) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_RuntimeError,
                            "OA traceback did not terminate");
            return NULL;
        }
        switch (st) {
        case S_C: {
            const double loop = (i > 0 && std::isfinite(C[i - 1]))
                                    ? C[i - 1] + ppC[i]
                                    : NEG;
            if (loop >= E[i]) {
                i -= 1;
            } else
                st = S_E;
            break;
        }
        case S_J: {
            const double loop = (i > 0 && std::isfinite(J[i - 1]))
                                    ? J[i - 1] + ppJ[i]
                                    : NEG;
            if (loop >= E[i]) {
                i -= 1;
            } else
                st = S_E;
            break;
        }
        case S_E:
            k = ek[i];
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
            if (ptr[(size_t)i * rowsz + k] & 8) {
                st = S_D;
                k -= 1;
            } else {
                st = S_M;
                k -= 1;
            }
            break;
        case S_B:
            st = (multihit && J[i] > N[i]) ? S_J : S_N;
            break;
        case S_N:
            i -= 1;
            break;
        }
    }
    return (PyObject *)out;
}


/* Global Needleman-Wunsch over two profiles' column-score matrix.
 * Used by the MAGUS-lite backbone merge (backbone_magus.py:
 * profile_profile_path): S [MA, MB] float64 match scores, linear gap.
 * Returns int8 ops array (0 = diag, 1 = up/A-only, 2 = left/B-only)
 * in path order. First-max-wins: diag > up > left.
 */
static PyObject *pp_nw(PyObject *self, PyObject *args) {
    PyObject *So;
    double gap;
    if (!PyArg_ParseTuple(args, "Od", &So, &gap)) return NULL;
    View2D S;
    if (!get2d(So, &S)) return NULL;
    npy_intp MA = S.rows, MB = S.cols;
    std::vector<double> prev((size_t)MB + 1), cur((size_t)MB + 1);
    std::vector<signed char> ptr((size_t)(MA + 1) * (MB + 1), 0);
    for (npy_intp j = 0; j <= MB; j++) { prev[j] = gap * (double)j; ptr[j] = 2; }
    ptr[0] = 0;
    for (npy_intp i = 1; i <= MA; i++) {
        cur[0] = gap * (double)i;
        ptr[(size_t)i * (MB + 1)] = 1;
        const double *Si = S.p + (size_t)(i - 1) * MB;
        for (npy_intp j = 1; j <= MB; j++) {
            double diag = prev[j - 1] + Si[j - 1];
            double up = prev[j] + gap;
            double left = cur[j - 1] + gap;
            double best = diag;
            signed char p = 0;
            if (up > best) { best = up; p = 1; }
            if (left > best) { best = left; p = 2; }
            cur[j] = best;
            ptr[(size_t)i * (MB + 1) + j] = p;
        }
        std::swap(prev, cur);
    }
    std::vector<signed char> ops;
    ops.reserve((size_t)(MA + MB));
    npy_intp i = MA, j = MB;
    while (i > 0 || j > 0) {
        signed char p = ptr[(size_t)i * (MB + 1) + j];
        if (i > 0 && j > 0 && p == 0) { ops.push_back(0); i--; j--; }
        else if (i > 0 && (j == 0 || p == 1)) { ops.push_back(1); i--; }
        else { ops.push_back(2); j--; }
    }
    npy_intp n = (npy_intp)ops.size();
    PyArrayObject *out =
        (PyArrayObject *)PyArray_SimpleNew(1, &n, NPY_INT8);
    if (!out) return NULL;
    signed char *op = (signed char *)PyArray_DATA(out);
    for (npy_intp t = 0; t < n; t++) op[t] = ops[(size_t)(n - 1 - t)];
    return (PyObject *)out;
}

/* Affine-gap profile-profile global alignment with position-dependent
 * gap costs (the progressive backbone merger, backbone_progressive.py).
 *
 * Inputs: S [MA, MB] float64 column-pair scores; gA/eA [MA] gap-open /
 * gap-extend costs charged when consuming an A column against a gap in
 * B (normally occA * open / occA * extend, both negative); gB/eB [MB]
 * likewise for B columns. Terminal gaps are charged extend-only.
 *
 * 3-state max DP:
 *   M[i,j] = S[i-1,j-1] + max(M,X,Y)[i-1,j-1]
 *   X[i,j] = max(M[i-1,j]+gA, X[i-1,j]+eA, Y[i-1,j]+gA)   (A col, B gap)
 *   Y[i,j] = max(M[i,j-1]+gB, X[i,j-1]+gB, Y[i,j-1]+eB)   (B col, A gap)
 *
 * Returns int8 ops (0 diag, 1 up/A-only, 2 left/B-only) in path order.
 * Replaces the reference's MAGUS graph merge behaviorally
 * (witch_msa/tools/magus/align/merge/) with a classic profile SP
 * alignment; see backbone_progressive.py for the surrounding design.
 */
static PyObject *pp_affine(PyObject *self, PyObject *args) {
    PyObject *So, *gAo, *eAo, *gBo, *eBo;
    if (!PyArg_ParseTuple(args, "OOOOO", &So, &gAo, &eAo, &gBo, &eBo))
        return NULL;
    View2D S;
    if (!get2d(So, &S)) return NULL;
    npy_intp MA = S.rows, MB = S.cols;
    const double *gA, *eA, *gB, *eB;
    npy_intp n1 = 0;
    if (!get1d(gAo, &gA, &n1)) return NULL;
    if (n1 != MA) {
        PyErr_SetString(PyExc_ValueError, "gA shape mismatch");
        return NULL;
    }
    if (!get1d(eAo, &eA, &n1)) return NULL;
    if (n1 != MA) {
        PyErr_SetString(PyExc_ValueError, "eA shape mismatch");
        return NULL;
    }
    if (!get1d(gBo, &gB, &n1)) return NULL;
    if (n1 != MB) {
        PyErr_SetString(PyExc_ValueError, "gB shape mismatch");
        return NULL;
    }
    if (!get1d(eBo, &eB, &n1)) return NULL;
    if (n1 != MB) {
        PyErr_SetString(PyExc_ValueError, "eB shape mismatch");
        return NULL;
    }
    size_t W = (size_t)MB + 1;
    std::vector<signed char> ops;
    Py_BEGIN_ALLOW_THREADS
    std::vector<double> Mp(W), Xp(W), Yp(W), Mc(W), Xc(W), Yc(W);
    /* ptr packing per cell: bits0-1 pred of M (0=M,1=X,2=Y),
     * bits2-3 pred of X, bits4-5 pred of Y */
    std::vector<unsigned char> ptr((size_t)(MA + 1) * W, 0);
    Mp[0] = 0.0; Xp[0] = NEG; Yp[0] = NEG;
    for (npy_intp j = 1; j <= MB; j++) {
        /* terminal top row: all-A-gapped prefix of B, extend-only */
        Mp[j] = NEG; Xp[j] = NEG;
        Yp[j] = (j == 1 ? 0.0 : Yp[j - 1]) + eB[j - 1];
        ptr[j] = (unsigned char)(2 << 4);
    }
    for (npy_intp i = 1; i <= MA; i++) {
        Mc[0] = NEG; Yc[0] = NEG;
        Xc[0] = (i == 1 ? 0.0 : Xp[0]) + eA[i - 1];
        if (i == 1) Xc[0] = eA[0];
        unsigned char *pr = ptr.data() + (size_t)i * W;
        pr[0] = (unsigned char)(1 << 2);
        const double *Si = S.p + (size_t)(i - 1) * MB;
        const double ga = gA[i - 1], ea = eA[i - 1];
        for (npy_intp j = 1; j <= MB; j++) {
            /* M */
            double bm = Mp[j - 1]; unsigned char pm = 0;
            if (Xp[j - 1] > bm) { bm = Xp[j - 1]; pm = 1; }
            if (Yp[j - 1] > bm) { bm = Yp[j - 1]; pm = 2; }
            Mc[j] = bm + Si[j - 1];
            /* X: consume A col i-1 against gap in B; terminal if j==MB */
            double gox = (j == MB) ? ea : ga;
            double bx = Mp[j] + gox; unsigned char px = 0;
            if (Xp[j] + ea > bx) { bx = Xp[j] + ea; px = 1; }
            if (Yp[j] + gox > bx) { bx = Yp[j] + gox; px = 2; }
            Xc[j] = bx;
            /* Y: consume B col j-1 against gap in A; terminal if i==MA */
            double gb = gB[j - 1], eb = eB[j - 1];
            double goy = (i == MA) ? eb : gb;
            double by = Mc[j - 1] + goy; unsigned char py = 0;
            if (Xc[j - 1] + goy > by) { by = Xc[j - 1] + goy; py = 1; }
            if (Yc[j - 1] + eb > by) { by = Yc[j - 1] + eb; py = 2; }
            Yc[j] = by;
            pr[j] = (unsigned char)(pm | (px << 2) | (py << 4));
        }
        std::swap(Mp, Mc); std::swap(Xp, Xc); std::swap(Yp, Yc);
    }
    /* traceback from best end state */
    int st = 0;
    double best = Mp[MB];
    if (Xp[MB] > best) { best = Xp[MB]; st = 1; }
    if (Yp[MB] > best) { best = Yp[MB]; st = 2; }
    ops.reserve((size_t)(MA + MB));
    npy_intp i = MA, j = MB;
    while (i > 0 || j > 0) {
        unsigned char p = ptr[(size_t)i * W + j];
        if (j == 0) st = 1;
        else if (i == 0) st = 2;
        if (st == 0) {
            ops.push_back(0);
            st = (p & 3);
            i--; j--;
        } else if (st == 1) {
            ops.push_back(1);
            st = ((p >> 2) & 3);
            i--;
        } else {
            ops.push_back(2);
            st = ((p >> 4) & 3);
            j--;
        }
    }
    Py_END_ALLOW_THREADS
    npy_intp n = (npy_intp)ops.size();
    PyArrayObject *out =
        (PyArrayObject *)PyArray_SimpleNew(1, &n, NPY_INT8);
    if (!out) return NULL;
    signed char *op = (signed char *)PyArray_DATA(out);
    for (npy_intp t = 0; t < n; t++) op[t] = ops[(size_t)(n - 1 - t)];
    return (PyObject *)out;
}

/* Witch-ng weighted merge DP + traceback (the banded_dp/traceback pair
 * in witch_tpu/ops/merge_dp.py, semantics of the reference's
 * alignSubQueriesNew DP, witch_msa/gcmm/aligner.py:426-482).
 *
 * Input: cw [n_res, band] float64 accumulated edge weights.
 * Output: int8 ops in forward order (0 = diagonal/match, 1 = up/query
 * insertion, 2 = left/deletion), covering the full path incl. the
 * i>0 / t>0 tails. Float64 op order matches the numpy version exactly
 * (d = prev[j] + w[j]; running cummax), so outputs are bit-identical.
 */
static PyObject *merge_dp_trace(PyObject *, PyObject *args) {
    PyObject *ocw;
    if (!PyArg_ParseTuple(args, "O", &ocw)) return NULL;
    View2D cw;
    if (!get2d(ocw, &cw)) return NULL;
    npy_intp n = cw.rows, band = cw.cols;
    std::vector<signed char> ops;
    Py_BEGIN_ALLOW_THREADS
    std::vector<double> prev((size_t)band + 1, 0.0),
        row((size_t)band + 1, 0.0);
    std::vector<signed char> bt((size_t)(n + 1) * (band + 1), 0);
    for (npy_intp i = 1; i <= n; i++) {
        const double *w = cw.p + (size_t)(i - 1) * band;
        signed char *bi = &bt[(size_t)i * (band + 1)];
        double run = 0.0;               /* row[j] (cummax so far) */
        for (npy_intp j = 0; j < band; j++) {
            double d = prev[j] + w[j];
            double up = prev[j + 1];
            bool has = w[j] > 0.0;
            double c = has ? (d > up ? d : up) : up;
            /* left wins only if strictly greater; diagonal beats up on
             * ties when the edge weight is positive */
            bi[j + 1] = (run > c) ? 2 : ((has && d >= up) ? 0 : 1);
            if (c > run) run = c;
            row[j + 1] = run;
        }
        row[0] = 0.0;
        std::swap(prev, row);
    }
    npy_intp i = n, t = band;
    while (i > 0 && t > 0) {
        signed char b = bt[(size_t)i * (band + 1) + t];
        ops.push_back(b);
        if (b == 0) { i--; t--; }
        else if (b == 1) i--;
        else t--;
    }
    while (i > 0) { ops.push_back(1); i--; }
    while (t > 0) { ops.push_back(2); t--; }
    Py_END_ALLOW_THREADS
    npy_intp no = (npy_intp)ops.size();
    PyArrayObject *out =
        (PyArrayObject *)PyArray_SimpleNew(1, &no, NPY_INT8);
    if (!out) return NULL;
    signed char *op = (signed char *)PyArray_DATA(out);
    for (npy_intp z = 0; z < no; z++) op[z] = ops[(size_t)(no - 1 - z)];
    return (PyObject *)out;
}

static PyMethodDef methods[] = {
    {"oa_align", oa_align, METH_VARARGS,
     "Optimal-accuracy fill+traceback -> aligned columns"},
    {"merge_dp_trace", merge_dp_trace, METH_VARARGS,
     "Witch-ng weighted merge DP + traceback -> ops"},
    {"pp_nw", pp_nw, METH_VARARGS,
     "Profile-profile global NW -> ops (0 diag, 1 up, 2 left)"},
    {"pp_affine", pp_affine, METH_VARARGS,
     "Affine profile-profile NW with per-column gap costs -> ops"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef mod = {PyModuleDef_HEAD_INIT, "_oa",
                                 "native OA kernel", -1, methods};

PyMODINIT_FUNC PyInit__oa(void) {
    import_array();
    return PyModule_Create(&mod);
}
