// Fused unihit posterior decoding + optimal-accuracy (OA) alignment +
// traceback, one CTA per (model, query) pair.
//
// Replaces: witch_tpu/ops/pallas_oa.py:_oa_kernel (the TPU kernel
// reached from oa_columns_device).
//
//   pass A  Backward from the terminal row L down to row 0 with exact
//           power-of-two rescaling; every row (bM, bI and the bN, bC,
//           exponent specials) goes to a device scratch buffer; row 0
//           gives the total score Z.
//   pass B  Forward with power-of-two rescaling; per row the posteriors
//           ppM/ppI/ppN/ppC (f32, as on the TPU) feed the OA DP
//           (witch_tpu/hmm/align_ref.py:oa_fill semantics), accumulated
//           in native f64; traceback pointers (pm 2 bits, pi 1 bit, pd 1
//           bit) go to a [L, Mp] byte plane in device memory, per-row E
//           and C decisions to two small arrays.
//   pass C  first-max-wins traceback (align_ref.oa_trace order) walked
//           by one thread; columns written in place.
//
// The minimum decision margin keeps the TPU kernel's definition
// (pallas_oa.py:pair_margin and the E/C margins): the M, I and D
// candidate sets contain their own maximum, so pair_margin counts every
// such cell as a tie (+inf); the margin comes from the E-state argmax
// over k (best minus second best, +inf on exact ties), the E choice
// between M and D at the argmax, and the C loop-versus-E choice.
//
// What bounds it on an H100: two sequential DP sweeps of L rows with
// block barriers between rows (latency), plus ~(8 + 1) * Mp bytes of
// device traffic per row (Backward rows written then read, pointers
// written), ~12 MB per pair at L = 448, Mp = 2816. The wrapper runs a
// chunk of pairs per launch so that scratch stays at a few GB.
//
// Design: f32 odds rows and f64 OA rows (36 * Mp bytes, ~100 KB at
// Mp = 2816) updated in place as in forward.cu, in shared memory up to
// Mp ~6,400; for wider models (up to the 16,384-state cap) the wrapper
// passes `rows_g` and each CTA keeps them in its own slice of that
// device buffer (L1/L2-cached). The layout is a template parameter, so
// the shared-memory instance addresses its rows as shared memory (a
// pointer chosen at run time would make every row access a generic
// one); no checkpoint/recompute (the TPU's
// answer to a small VMEM); f64 OA accumulators instead of the TPU's
// double-float pairs.

#include <float.h>
#include <math.h>

#include "common.cuh"

static constexpr double NEGD = -(double)FLT_MAX;
static constexpr float LN2F = 0.693147182464599609375f;   // f32(ln 2)
// bytes of working rows per model state: oM oI oD (f64) + fM fI fD (f32)
static constexpr size_t OA_ROW_BYTES = 3 * (sizeof(double) + sizeof(float));

struct ArgMax {
    double v;
    int k;
};

static __device__ ArgMax block_argmax_first(ArgMax x, ArgMax *sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const double ov = __shfl_xor_sync(FULL_MASK, x.v, s);
        const int ok = __shfl_xor_sync(FULL_MASK, x.k, s);
        if (ov > x.v || (ov == x.v && ok < x.k)) {
            x.v = ov;
            x.k = ok;
        }
    }
    if (lane == 0) sh[w] = x;
    __syncthreads();
    ArgMax r = sh[0];
    for (int i = 1; i < NWARP; ++i)
        if (sh[i].v > r.v || (sh[i].v == r.v && sh[i].k < r.k)) r = sh[i];
    __syncthreads();
    return r;
}

// exclusive prefix max over threads (chunk order); NEGD before thread 0
static __device__ double prefix_max_enter(double m, double *sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    double x = m;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const double p = __shfl_up_sync(FULL_MASK, x, s);
        if (lane >= s) x = fmax(x, p);
    }
    if (lane == 31) sh[w] = x;
    __syncthreads();
    double enter = NEGD;
    for (int v = 0; v < w; ++v) enter = fmax(enter, sh[v]);
    const double p1 = __shfl_up_sync(FULL_MASK, x, 1);
    if (lane > 0) enter = fmax(enter, p1);
    __syncthreads();
    return enter;
}

template <bool kDevRows>
__global__ void oa_kernel(const float *__restrict__ em,
                          const float *__restrict__ trans,
                          const int32_t *__restrict__ model_of,
                          const int32_t *__restrict__ ms,
                          const int32_t *__restrict__ codes,
                          const int64_t *__restrict__ code_off,
                          const int32_t *__restrict__ lens,
                          const float *__restrict__ pmoves,
                          float *__restrict__ brows, float *__restrict__ bspec,
                          uint8_t *__restrict__ ptr, int32_t *__restrict__ rowk,
                          uint8_t *__restrict__ rowf,
                          int32_t *__restrict__ cols, float *__restrict__ stat,
                          void *rows_g, int Mp, int K, int Ldmax) {
    extern __shared__ double smem_d[];
    double *base = kDevRows ? (double *)((char *)rows_g + (size_t)blockIdx.x *
                                                             OA_ROW_BYTES * Mp)
                            : smem_d;
    double *oM = base, *oI = base + Mp, *oD = base + 2 * Mp;
    float *fM = (float *)(base + 3 * Mp), *fI = fM + Mp, *fD = fM + 2 * Mp;
    __shared__ Aff shA[NWARP];
    __shared__ float shR[2 * NWARP];
    __shared__ double shD[2 * NWARP];
    __shared__ ArgMax shX[NWARP];
    __shared__ int shI[NWARP];

    const int p = blockIdx.x;
    const int h = model_of[p];
    const int Mm = ms[p];
    const float *tr = trans + (size_t)h * 8 * Mp;
    const float *emh = em + (size_t)h * K * Mp;
    const int L = lens[p];
    const int32_t *cs = codes + code_off[p];
    int32_t *co = cols + code_off[p];
    const float pmove = pmoves[p];
    const float ploop = 1.0f - pmove;
    float *BR = brows + (size_t)p * (Ldmax + 1) * 2 * Mp;
    float *BS = bspec + (size_t)p * (Ldmax + 1) * 3;
    uint8_t *PT = ptr + (size_t)p * Ldmax * Mp;
    int32_t *RK = rowk + (size_t)p * Ldmax;
    uint8_t *RF = rowf + (size_t)p * Ldmax;

    int k0, k1;
    chunk_of(Mp, k0, k1);
    for (int j = threadIdx.x; j < L; j += NT) co[j] = -1;

    // ---------------- pass A: Backward, rows stored ------------------
    float *bM = fM, *bI = fI, *sD = fD;
    backward_terminal_row(bM, bI, sD, tr, pmove, Mp, shA);
    float bN = 0.f, bC = pmove, bled = 0.f;
    for (int k = k0; k < k1; ++k) {
        BR[(size_t)L * 2 * Mp + k] = bM[k];
        BR[(size_t)L * 2 * Mp + Mp + k] = bI[k];
    }
    if (threadIdx.x == 0) {
        BS[L * 3 + 0] = bN;
        BS[L * 3 + 1] = bC;
        BS[L * 3 + 2] = bled;
    }
    for (int i = L - 1; i >= 0; --i) {
        __syncthreads();
        const float *e = emh + (size_t)cs[i] * Mp;   // residue i+1
        const float bCn = bC * ploop;
        float pB, mx;
        backward_core_row(bM, bI, sD, tr, e, bCn, Mp, pB, mx, shA);
        block_sum_max(pB, mx, shR);
        const float bNn = bN * ploop + pB * pmove;
        const float scale = fmaxf(mx, fmaxf(bNn, fmaxf(bCn, SCALE_FLOOR)));
        float inv, kexp;
        po2_scale(scale, inv, kexp);
        float *Ri = BR + (size_t)i * 2 * Mp;
        for (int k = k0; k < k1; ++k) {
            bM[k] *= inv;
            bI[k] *= inv;
            Ri[k] = bM[k];
            Ri[Mp + k] = bI[k];
        }
        bN = bNn * inv;
        bC = bCn * inv;
        bled = bled + kexp;
        if (threadIdx.x == 0) {
            BS[i * 3 + 0] = bN;
            BS[i * 3 + 1] = bC;
            BS[i * 3 + 2] = bled;
        }
    }
    const float Zlog = logf(fmaxf(bN, SCALE_FLOOR)) + bled * LN2F;
    __syncthreads();   // BS visible to every thread

    // ---------------- pass B: Forward + OA fill -----------------------
    for (int k = k0; k < k1; ++k) {
        fM[k] = 0.f;
        fI[k] = 0.f;
        fD[k] = 0.f;
        oM[k] = NEGD;
        oI[k] = NEGD;
        oD[k] = NEGD;
    }
    float fN = 1.f, fB = pmove, fC = 0.f, fled = 0.f;
    double oN = 0.0, oC = NEGD, mm = INFINITY;
    for (int i = 1; i <= L; ++i) {
        __syncthreads();
        const float fN0 = fN, fB0 = fB, fC0 = fC, fled0 = fled;
        const float *e = emh + (size_t)cs[i - 1] * Mp;
        float s, mx;
        forward_core_row(fM, fI, fD, tr, e, fB0, Mp, s, mx, shA);
        block_sum_max(s, mx, shR);
        const float Cn = fC0 * ploop + s;
        const float Nn = fN0 * ploop;
        const float Bn = Nn * pmove;
        const float scale = fmaxf(mx, fmaxf(Cn, fmaxf(Nn, SCALE_FLOOR)));
        float inv, kexp;
        po2_scale(scale, inv, kexp);
        scale_rows(fM, fI, fD, inv, Mp);
        fN = Nn * inv;
        fB = Bn * inv;
        fC = Cn * inv;
        fled = fled0 + kexp;

        const float bN_i = BS[i * 3 + 0], bC_i = BS[i * 3 + 1],
                    bled_i = BS[i * 3 + 2];
        const float sc = expf((fled + bled_i) * LN2F - Zlog);
        const float scN = expf((fled0 + bled_i) * LN2F - Zlog);
        const float ppN = fN0 * ploop * bN_i * scN;
        const float ppC = fC0 * ploop * bC_i * scN;
        const float *Ri = BR + (size_t)i * 2 * Mp;
        uint8_t *Pi = PT + (size_t)(i - 1) * Mp;

        // M and I cells, in place (descending: oX[k-1] still old)
        double lM = NEGD, lI = NEGD, lD = NEGD;
        if (k0 < k1 && k0 >= 1) {
            lM = oM[k0 - 1];
            lI = oI[k0 - 1];
            lD = oD[k0 - 1];
        }
        __syncthreads();
        for (int k = k1 - 1; k >= k0; --k) {
            const bool km = k >= 1 && k <= Mm;
            const bool im = k >= 1 && k <= Mm - 1;
            const double cmm = (k >= 1) ? ((k == k0) ? lM : oM[k - 1]) : NEGD;
            const double cim = (k >= 1) ? ((k == k0) ? lI : oI[k - 1]) : NEGD;
            const double cdm = (k >= 1) ? ((k == k0) ? lD : oD[k - 1]) : NEGD;
            const double ch = fmax(fmax(fmax(cmm, cim), cdm), oN);
            const float ppM = km ? fM[k] * Ri[k] * sc : 0.f;
            const float ppI = im ? fI[k] * Ri[Mp + k] * sc : 0.f;
            const int pm = (cmm == ch) ? 0 : (cim == ch) ? 1 : (cdm == ch) ? 2 : 3;
            const double pMk = oM[k], pIk = oI[k];
            const int pi = (pMk >= pIk) ? 0 : 1;
            oM[k] = km ? ch + (double)ppM : NEGD;
            oI[k] = im ? fmax(pMk, pIk) + (double)ppI : NEGD;
            Pi[k] = (uint8_t)(pm + 4 * pi);
        }
        __syncthreads();
        // D cells: Dx[k] = max_{j<k} Mx[j] on 2..M (prefix max)
        double cm = NEGD;
        for (int k = k0; k < k1; ++k) cm = fmax(cm, oM[k]);
        double run = prefix_max_enter(cm, shD);
        for (int k = k0; k < k1; ++k) {
            oD[k] = (k >= 2 && k <= Mm) ? run : NEGD;
            run = fmax(run, oM[k]);
        }
        __syncthreads();
        // pd, and the E-state argmax over k (M before D, lowest k first)
        ArgMax best{NEGD, Mp + 1};
        for (int k = k0; k < k1; ++k) {
            const double sM1 = (k >= 1) ? oM[k - 1] : NEGD;
            const double sD1 = (k >= 1) ? oD[k - 1] : NEGD;
            Pi[k] = (uint8_t)(Pi[k] + 8 * ((sM1 >= sD1) ? 0 : 1));
            if (k >= 1 && k <= Mm) {
                const double cE = fmax(oM[k], oD[k]);
                if (cE > best.v) {
                    best.v = cE;
                    best.k = k;
                }
            }
        }
        best = block_argmax_first(best, shX);
        const double r = best.v;
        const int kE = best.k;
        int nb = 0;
        double s2 = NEGD;
        for (int k = max(k0, 1); k < min(k1, Mm + 1); ++k) {
            const double cE = fmax(oM[k], oD[k]);
            if (cE == r) nb += 1;
            else if (cE < r) s2 = fmax(s2, cE);
        }
        nb = block_reduce(nb, OpSum(), shI);
        s2 = block_reduce(s2, OpMax(), shD);
        const double mE = (nb > 1 || s2 == NEGD) ? INFINITY : r - s2;
        const double MxkE = oM[kE];
        const bool eIsD = r > MxkE;
        const double mED = (MxkE == r) ? INFINITY : r - MxkE;
        const double cl = oC + (double)ppC;
        const bool cge = cl >= r;
        const double mC = (cl == r) ? INFINITY : fabs(cl - r);
        oC = cge ? cl : r;
        oN = oN + (double)ppN;
        mm = fmin(mm, fmin(mE, fmin(mC, mED)));
        if (threadIdx.x == 0) {
            RK[i - 1] = kE;
            RF[i - 1] = (uint8_t)((eIsD ? 1 : 0) + (cge ? 2 : 0));
        }
    }
    __syncthreads();

    // ---------------- pass C: traceback ---------------------------------
    if (threadIdx.x != 0) return;
    // states: 0=C 1=E 2=M 3=I 4=D 5=N
    int i = L, k = 0, st = 0, steps = 0, dead = (L > 0) ? 0 : 1;
    const int max_steps = 2 * Ldmax + Mp + 16;
    while (!(st == 5 && i == 0) && steps < max_steps && !dead) {
        const int row = max(i, 1) - 1;
        const int kEr = RK[row];
        const int fl = RF[row];
        const int pb = PT[(size_t)row * Mp + k];
        const int pm = pb & 3, pi = (pb >> 2) & 1, pd = (pb >> 3) & 1;
        int ni = i, nk = k, nst = st;
        switch (st) {
        case 0:
            if (i > 0 && (fl & 2)) ni = i - 1;
            else nst = 1;
            break;
        case 1:
            nst = (fl & 1) ? 4 : 2;
            nk = kEr;
            break;
        case 2:
            if (i > 0) co[row] = k - 1;
            nst = (pm == 0) ? 2 : (pm == 1) ? 3 : (pm == 2) ? 4 : 5;
            nk = (pm == 3) ? 0 : k - 1;
            ni = i - 1;
            break;
        case 3:
            nst = (pi == 0) ? 2 : 3;
            ni = i - 1;
            break;
        case 4:
            nst = (pd == 0) ? 2 : 4;
            nk = k - 1;
            break;
        default:
            ni = i - 1;
            break;
        }
        if (ni < 0 || nk < 0 || nk >= Mp) dead = 1;
        i = ni;
        k = nk;
        st = nst;
        steps += 1;
    }
    const bool ok = (st == 5 && i == 0 && !dead);
    stat[(size_t)p * 4 + 0] = (float)mm;
    stat[(size_t)p * 4 + 1] = ok ? 1.f : 0.f;
    stat[(size_t)p * 4 + 2] = Zlog;
    stat[(size_t)p * 4 + 3] = (float)steps;
}

extern "C" int witch_oa(const float *em, const float *trans,
                        const int32_t *model_of, const int32_t *ms,
                        const int32_t *codes, const int64_t *code_off,
                        const int32_t *lens, const float *pmoves,
                        float *brows, float *bspec, uint8_t *ptr,
                        int32_t *rowk, uint8_t *rowf, int32_t *cols,
                        float *stat, void *rows_g, int n, int Mp, int K,
                        int Ldmax, void *stream) {
    if (rows_g) {
        if (n > 0)
            oa_kernel<true><<<(unsigned)n, NT, 0, (cudaStream_t)stream>>>(
                em, trans, model_of, ms, codes, code_off, lens, pmoves, brows,
                bspec, ptr, rowk, rowf, cols, stat, rows_g, Mp, K, Ldmax);
        return (int)cudaGetLastError();
    }
    const size_t smem = OA_ROW_BYTES * Mp;
    cudaError_t err = set_smem((const void *)oa_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    if (n > 0)
        oa_kernel<false><<<(unsigned)n, NT, smem, (cudaStream_t)stream>>>(
            em, trans, model_of, ms, codes, code_off, lens, pmoves, brows,
            bspec, ptr, rowk, rowf, cols, stat, nullptr, Mp, K, Ldmax);
    return (int)cudaGetLastError();
}
