// The exact-f32 print overlay's value streams on Hopper: the native
// engine's striped f32 Forward, Backward, posterior decoding and null2 by
// expectation (native/stoch_f32.h: forward_f32, backward_f32,
// decoding_f32, null2_by_expectation_f32), value for value.
//
// Replaces no TPU kernel: the JAX package runs the overlay on its host
// engine (witch_tpu/pipeline.py). This kernel was added because that host
// work held about a third of a dna1k job while the card sat idle
// (ops/overlay.py splits exact_scores32 around it; every libm call stays
// on the host, so nothing here needs the reference binary's libm).
//
// Two launches (ops/overlay.py):
//   A  overlay_seq_kernel, one CTA per (model, fragment) pair: the
//      full-sequence multihit Forward, then the Backward on the Forward's
//      row scales, both keeping one row; writes both xmx rows [L+1][6]
//      and the Backward's own-scales flag.
//   B  overlay_env_kernel, one CTA per single-envelope region: the unihit
//      Forward storing its M and I planes in device scratch, the Backward
//      overwriting them with the products f*b, the posterior sums in
//      ascending row order, and null2[x] for the canonical codes (with
//      the N/J/C term added); writes the Forward's xmx rows, null2 and a
//      refusal flag (totr = 1/bN(0) infinite: decoding_f32's eslERANGE).
//
// Exactness. The host engine reproduces an SSE engine compiled by icc:
// 4 lanes, node k = z*Q + q + 1 in lane z of stripe q, f32 multiplies and
// adds rounded one by one (the host builds with -ffp-contract=off), the
// specials in double rounded once each, divisions in double or f32 as the
// host divides. Here every multiply and add is __fmul_rn / __fadd_rn (or
// the double forms): nvcc never contracts them into an FMA, whatever
// NVCC_FLAGS say. Denormals are kept (no -ftz). Sums keep the host's
// order: each lane's E (Forward) and B (Backward) fold runs over the
// stripes in order on one thread, and the folds end in the
// (a0 + a1) + (a2 + a3) reduction.
//
// What bounds it: the serial chains, not bytes or operations. A row's M,
// I and first D values of all Q stripes depend only on the previous row
// and run in parallel (256 threads, up to 8 cells each, staged in
// registers so that the row is updated in place in shared memory); what
// stays serial, one thread per lane: the Forward's E fold (2Q adds), its
// first delete pass (Q multiply-add pairs) and the later passes up to the
// early break (or until the carry is 0); the Backward's B fold (Q adds),
// its first delete pass (Q multiply-add-add triples) and three product
// passes (until the carry is 0). Each chain loads its operands a block of
// OV_BLK steps ahead, so a step waits on its arithmetic alone. At Q = 375
// that is ~17,000 dependent-operation cycles a row of Forward and
// Backward; one item alone measured ~25 us a row on an H100 (PERF.md).
// Registers are capped (OV_CPS) so that 4 CTAs share an SM: the one row
// of Q x 12 floats in shared memory (18 KB at Q = 375) would allow more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OV_NT = 256;   // threads of a CTA
constexpr int OV_MAXC = 8;   // row cells a thread stages: 4 Q <= OV_NT * OV_MAXC
constexpr int OV_CPS = 4;    // CTAs an SM holds (registers capped to fit)
constexpr int OV_BLK = 8;    // chain steps whose operands load together

enum { TBM = 0, TMM, TIM, TDM, TMD, TMI, TII };
enum { XE = 0, XN, XJ, XB, XC, XS };   // xmx columns; XS = SCALE
enum { SE = 0, SN, SJ, SC };           // specials of the length model

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double dm(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double da(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rd(double a) { return __double2float_rn(a); }

// The model's striped profile (native exact32_tables): rf[x][q][z] match
// odds, tf[(7q + t)][z] transitions, tf[(7Q + q)][z] the DD tail.
struct Prof {
    const float *rf, *tf;
    int Q;
    __device__ __forceinline__ float t(int q, int k, int z) const {
        return __ldg(tf + (7 * q + k) * 4 + z);
    }
    __device__ __forceinline__ float dd(int q, int z) const {
        return __ldg(tf + (7 * Q + q) * 4 + z);
    }
    __device__ __forceinline__ const float *em(int x) const {
        return rf + (size_t)x * Q * 4;
    }
};

// The length model (xf_set / xf_set_unihit), in f32 as the host sets it.
struct Xf {
    float move[4], loop[4];
};

__device__ Xf length_model(int L, float nj, bool unihit) {
    Xf x;
    if (unihit) nj = 0.0f;
    const float denom = fa(fa(__int2float_rn(L), 2.0f), nj);
    const float pm = __fdiv_rn(fa(2.0f, nj), denom);
    const float pl = __fsub_rn(1.0f, pm);
    x.move[SE] = unihit ? 1.0f : 0.5f;
    x.loop[SE] = unihit ? 0.0f : 0.5f;
    for (int s = SN; s <= SC; s++) {
        x.move[s] = pm;
        x.loop[s] = pl;
    }
    return x;
}

struct Sh {
    float carry[4];   // the Forward's rshift carry into stripe 0's D
    float xem[4];     // the Forward's E fold over the M cells
    float xB;         // the Forward's B of the previous row
    float nE;         // the Backward's unscaled E of this row
    float inv;        // this row's rescale multiplier
    int resc;         // this row rescales
    float xfac;       // null2's N/J/C term
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// (a0 + a1) + (a2 + a3) over lanes 0-3 of the calling 4-lane group; the
// sum is returned on its first lane.
__device__ __forceinline__ float hsum4(float a, unsigned mask) {
    const float b = fa(a, __shfl_down_sync(mask, a, 1));
    return fa(b, __shfl_down_sync(mask, b, 2));
}

// a + x[0] + x[12] + ... + x[12 (Q - 1)], added in that order (one
// lane's M or D cells of a row)
__device__ __forceinline__ float fold(const float *x, int Q, float a) {
    for (int q0 = 0; q0 < Q; q0 += OV_BLK) {
        float v[OV_BLK];
#pragma unroll
        for (int u = 0; u < OV_BLK; u++) v[u] = x[min(q0 + u, Q - 1) * 12];
#pragma unroll
        for (int u = 0; u < OV_BLK; u++)
            if (q0 + u < Q) a = fa(a, v[u]);
    }
    return a;
}

// The Backward's B fold of lane z over the next row's M cells (`row`):
// sum of (M(q) x rf(q)) x t_bm(q) over the stripes, descending (rows 1..L
// - 1) or ascending (row 0)
__device__ __forceinline__ float b_fold(const Prof &P, const float *rp,
                                        const float *row, int z, bool desc) {
    const int Q = P.Q;
    float a = 0.0f;
    for (int k0 = 0; k0 < Q; k0 += OV_BLK) {
        float v[OV_BLK];
#pragma unroll
        for (int u = 0; u < OV_BLK; u++) {
            const int k = min(k0 + u, Q - 1), q = desc ? Q - 1 - k : k;
            v[u] = fm(fm(row[q * 12 + z], __ldg(rp + q * 4 + z)),
                      P.t(q, TBM, z));
        }
#pragma unroll
        for (int u = 0; u < OV_BLK; u++)
            if (k0 + u < Q) a = fa(a, v[u]);
    }
    return a;
}

// forward_f32: rows 1..L over `row` (Q x [M, D, I] x 4 in shared memory),
// xmx rows to global. PLANES: row i's M and I (after its rescale) to
// plane + (i - 1) * 8Q as [M: Q x 4][I: Q x 4].
template <bool PLANES>
__device__ void forward(const Prof &P, const Xf &xf, const uint8_t *codes,
                        int L, float *row, Sh &sh, float *xmx,
                        float *plane) {
    const int Q = P.Q, nc = 4 * Q, tid = threadIdx.x;
    const int lane = lane_id(), warp = warp_id();
    for (int c = tid; c < Q * 12; c += OV_NT) row[c] = 0.0f;
    const double Nloop = xf.loop[SN], Nmove = xf.move[SN];
    const double Jloop = xf.loop[SJ], Jmove = xf.move[SJ];
    const double Cloop = xf.loop[SC];
    const double Eloop = xf.loop[SE], Emove = xf.move[SE];
    // the specials' running values live on thread 0
    float xN = 1.0f, xJ = 0.0f, xC = 0.0f;
    if (tid == 0) {
        xmx[XE] = 0.0f; xmx[XN] = 1.0f; xmx[XJ] = 0.0f;
        xmx[XB] = xf.move[SN]; xmx[XC] = 0.0f; xmx[XS] = 1.0f;
        sh.xB = xf.move[SN];
        sh.carry[0] = 0.0f;
    }
    __syncthreads();
    for (int i = 1; i <= L; i++) {
        const float *rp = P.em(codes[i - 1]);
        const float xB = sh.xB;
        float sv[OV_MAXC], iv[OV_MAXC], dv[OV_MAXC];
#pragma unroll
        for (int k = 0; k < OV_MAXC; k++) {
            const int c = tid + k * OV_NT;
            if (c < nc) {
                const int q = c >> 2, z = c & 3;
                float pm = 0.0f, pd = 0.0f, pi = 0.0f;
                if (q > 0) {
                    const float *p = row + (q - 1) * 12 + z;
                    pm = p[0]; pd = p[4]; pi = p[8];
                } else if (z > 0) {   // rshift of the last stripe
                    const float *p = row + (Q - 1) * 12 + z - 1;
                    pm = p[0]; pd = p[4]; pi = p[8];
                }
                float s = fm(xB, P.t(q, TBM, z));
                s = fa(s, fm(pm, P.t(q, TMM, z)));
                s = fa(s, fm(pi, P.t(q, TIM, z)));
                s = fa(s, fm(pd, P.t(q, TDM, z)));
                s = fm(s, __ldg(rp + c));
                sv[k] = s;
                // I sources the unshifted stripe q of the previous row
                iv[k] = fa(fm(row[q * 12 + z], P.t(q, TMI, z)),
                           fm(row[q * 12 + 8 + z], P.t(q, TII, z)));
                dv[k] = fm(s, P.t(q, TMD, z));
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < OV_MAXC; k++) {
            const int c = tid + k * OV_NT;
            if (c < nc) {
                const int q = c >> 2, z = c & 3;
                row[q * 12 + z] = sv[k];
                row[q * 12 + 8 + z] = iv[k];
                // D of stripe q + 1 starts at M(q) x t_md(q); the last
                // stripe's rshifts into stripe 0 through the first pass
                if (q < Q - 1) row[(q + 1) * 12 + 4 + z] = dv[k];
                else if (z < 3) sh.carry[z + 1] = dv[k];
            }
        }
        __syncthreads();
        if (warp == 0 && lane < 4) {
            const int z = lane;
            // first DD pass: M->D and D->D, serial over the stripes
            float x = fa(sh.carry[z], 0.0f);
            row[4 + z] = x;
            for (int q0 = 1; q0 < Q; q0 += OV_BLK) {
                float t[OV_BLK], d[OV_BLK];
#pragma unroll
                for (int u = 0; u < OV_BLK; u++) {
                    const int q = min(q0 + u, Q - 1);
                    t[u] = P.dd(q - 1, z);
                    d[u] = row[q * 12 + 4 + z];
                }
#pragma unroll
                for (int u = 0; u < OV_BLK; u++)
                    if (q0 + u < Q) {
                        x = fa(fm(x, t[u]), d[u]);
                        row[(q0 + u) * 12 + 4 + z] = x;
                    }
            }
            float carry = fm(x, P.dd(Q - 1, z));
            // serialized DD passes with the early break. A carry of 0
            // changes nothing from there on, so a pass stops at the first
            // block that starts with one
            for (int j = 1; j < 4; j++) {
                float c = __shfl_up_sync(0xfu, carry, 1);
                if (z == 0) c = 0.0f;
                bool changed = false;
                for (int q0 = 0; q0 < Q && c != 0.0f; q0 += OV_BLK) {
                    float t[OV_BLK], d[OV_BLK];
#pragma unroll
                    for (int u = 0; u < OV_BLK; u++) {
                        const int q = min(q0 + u, Q - 1);
                        t[u] = P.dd(q, z);
                        d[u] = row[q * 12 + 4 + z];
                    }
#pragma unroll
                    for (int u = 0; u < OV_BLK; u++)
                        if (q0 + u < Q) {
                            const float nv = fa(c, d[u]);
                            changed |= nv > d[u];
                            row[(q0 + u) * 12 + 4 + z] = nv;
                            c = fm(c, t[u]);
                        }
                }
                carry = c;
                if (!__any_sync(0xfu, changed)) break;
            }
        } else if (warp == 1 && lane < 4) {
            sh.xem[lane] = fold(row + lane, Q, 0.0f);
        }
        __syncthreads();
        if (warp == 0 && lane < 4) {
            const float a = fold(row + 4 + lane, Q, sh.xem[lane]);
            float xE = hsum4(a, 0xfu);
            if (lane == 0) {
                float nN = rd(dm((double)xN, Nloop));
                float nJ = rd(da(dm((double)xJ, Jloop), dm((double)xE, Eloop)));
                float nC = rd(da(dm((double)xC, Cloop), dm((double)xE, Emove)));
                float nB = rd(da(dm((double)nN, Nmove), dm((double)nJ, Jmove)));
                float scale = 1.0f;
                int resc = 0;
                if ((double)xE > 1.0e4) {
                    const double dxE = (double)xE;
                    sh.inv = rd(__ddiv_rn(1.0, dxE));
                    nN = rd(__ddiv_rn((double)nN, dxE));
                    nC = rd(__ddiv_rn((double)nC, dxE));
                    nJ = rd(__ddiv_rn((double)nJ, dxE));
                    nB = rd(__ddiv_rn((double)nB, dxE));
                    scale = xE;
                    xE = 1.0f;
                    resc = 1;
                }
                float *xr = xmx + (size_t)i * 6;
                xr[XE] = xE; xr[XN] = nN; xr[XJ] = nJ;
                xr[XB] = nB; xr[XC] = nC; xr[XS] = scale;
                xN = nN; xJ = nJ; xC = nC;
                sh.xB = nB;
                sh.resc = resc;
            }
        }
        __syncthreads();
        const int resc = sh.resc;
        if (resc || PLANES) {
            const float inv = sh.inv;
            float *pl = plane + (size_t)(i - 1) * 8 * Q;
            for (int c = tid; c < nc; c += OV_NT) {
                float *cell = row + (c >> 2) * 12 + (c & 3);
                float m = cell[0], d = cell[4], v = cell[8];
                if (resc) {
                    m = fm(m, inv); d = fm(d, inv); v = fm(v, inv);
                    cell[0] = m; cell[4] = d; cell[8] = v;
                }
                if (PLANES) {
                    pl[c] = m;
                    pl[nc + c] = v;
                }
            }
            if (resc) __syncthreads();
        }
    }
}

// backward_f32 on the Forward's row scales (xmx_f), rows L..0 over `row`,
// xmx rows to xmb. PROD: row i's M and I (after its rescale) multiply
// the Forward's stored planes in place (decoding_f32's f x b, before its
// x cellf). Returns the own-scales flag on thread 0.
template <bool PROD>
__device__ int backward(const Prof &P, const Xf &xf, const uint8_t *codes,
                        int L, float *row, Sh &sh, const float *xmf,
                        float *xmb, float *plane) {
    const int Q = P.Q, nc = 4 * Q, tid = threadIdx.x;
    const int lane = lane_id(), warp = warp_id();
    const double Nloop = xf.loop[SN], Nmove = xf.move[SN];
    const double Jloop = xf.loop[SJ], Jmove = xf.move[SJ];
    const double Cloop = xf.loop[SC];
    const double Eloop = xf.loop[SE], Emove = xf.move[SE];
    float xN = 0.0f, xJ = 0.0f, xC = xf.move[SC];
    int own = 0;
    // row L: M = D = xE, I = 0; its delete chains are the general row's
    // with nE = 0 (x + 0 = x for the non-negative values here)
    const float xEL = rd(dm((double)xC, Emove));
    for (int c = tid; c < nc; c += OV_NT) {
        float *cell = row + (c >> 2) * 12 + (c & 3);
        cell[0] = xEL; cell[4] = xEL; cell[8] = 0.0f;
    }
    if (tid == 0) sh.nE = 0.0f;
    __syncthreads();
    for (int i = L; i >= 1; i--) {
        if (i < L) {
            const float *rp = P.em(codes[i]);
            float bm[OV_MAXC], bd[OV_MAXC], bi[OV_MAXC];
#pragma unroll
            for (int k = 0; k < OV_MAXC; k++) {
                const int c = tid + k * OV_NT;
                if (c < nc) {
                    const int q = c >> 2, z = c & 3;
                    // the next stripe, or stripe 0 leftshifted
                    float mn = 0.0f, tmm = 0.0f, tim = 0.0f, tdm = 0.0f;
                    if (q < Q - 1) {
                        mn = fm(row[(q + 1) * 12 + z], __ldg(rp + c + 4));
                        tmm = P.t(q + 1, TMM, z);
                        tim = P.t(q + 1, TIM, z);
                        tdm = P.t(q + 1, TDM, z);
                    } else if (z < 3) {
                        mn = fm(row[z + 1], __ldg(rp + z + 1));
                        tmm = P.t(0, TMM, z + 1);
                        tim = P.t(0, TIM, z + 1);
                        tdm = P.t(0, TDM, z + 1);
                    }
                    const float ip = row[q * 12 + 8 + z];
                    bi[k] = fa(fm(ip, P.t(q, TII, z)), fm(mn, tim));
                    bd[k] = fm(mn, tdm);
                    bm[k] = fa(fm(mn, tmm), fm(ip, P.t(q, TMI, z)));
                }
            }
            if (warp == 0 && lane < 4) {
                // B fold over the stripes, descending, on row i + 1
                const int z = lane;
                float xB = hsum4(b_fold(P, rp, row, z, true), 0xfu);
                if (lane == 0) {
                    float nJ = rd(da(dm((double)xJ, Jloop), dm((double)xB, Jmove)));
                    float nC = rd(dm((double)xC, Cloop));
                    float nN = rd(da(dm((double)xN, Nloop), dm((double)xB, Nmove)));
                    float nE = rd(da(dm((double)nJ, Eloop), dm((double)nC, Emove)));
                    sh.nE = nE;
                    if ((double)xB > 1e16) own = 1;
                    float scale = own ? ((double)xB > 1e4 ? xB : 1.0f)
                                      : xmf[(size_t)i * 6 + XS];
                    int resc = 0;
                    if ((double)scale > 1.0) {
                        const double s = (double)scale;
                        sh.inv = rd(__ddiv_rn(1.0, s));
                        nJ = rd(__ddiv_rn((double)nJ, s));
                        nC = rd(__ddiv_rn((double)nC, s));
                        nN = rd(__ddiv_rn((double)nN, s));
                        nE = rd(__ddiv_rn((double)nE, s));
                        xB = rd(__ddiv_rn((double)xB, s));
                        resc = 1;
                    }
                    sh.resc = resc;
                    float *xr = xmb + (size_t)i * 6;
                    xr[XE] = nE; xr[XN] = nN; xr[XJ] = nJ;
                    xr[XB] = xB; xr[XC] = nC; xr[XS] = scale;
                    xJ = nJ; xC = nC; xN = nN;
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < OV_MAXC; k++) {
                const int c = tid + k * OV_NT;
                if (c < nc) {
                    float *cell = row + (c >> 2) * 12 + (c & 3);
                    cell[0] = bm[k]; cell[4] = bd[k]; cell[8] = bi[k];
                }
            }
        } else if (tid == 0) {
            const float s = xmf[(size_t)L * 6 + XS];
            int resc = 0;
            float xE = xEL;
            if ((double)s > 1.0) {
                sh.inv = rd(__ddiv_rn(1.0, (double)s));
                xE = rd(__ddiv_rn((double)xE, (double)s));
                xC = rd(__ddiv_rn((double)xC, (double)s));
                resc = 1;
            }
            sh.resc = resc;
            float *xr = xmb + (size_t)L * 6;
            xr[XE] = xE; xr[XN] = 0.0f; xr[XJ] = 0.0f;
            xr[XB] = 0.0f; xr[XC] = xC; xr[XS] = s;
        }
        __syncthreads();
        if (warp == 0 && lane < 4) {
            const int z = lane;
            const float nE = sh.nE;
            // pass 1: seeded with leftshift(D(0) + E), carries the
            // updated D: D(q) = (E + carry x t_dd(q)) + D(q)
            float dcv = z < 3 ? fa(row[4 + z + 1], nE) : 0.0f;
            __syncwarp(0xfu);
            for (int q0 = Q - 1; q0 >= 0; q0 -= OV_BLK) {
                float t[OV_BLK], d[OV_BLK];
#pragma unroll
                for (int u = 0; u < OV_BLK; u++) {
                    const int q = max(q0 - u, 0);
                    t[u] = P.dd(q, z);
                    d[u] = row[q * 12 + 4 + z];
                }
#pragma unroll
                for (int u = 0; u < OV_BLK; u++)
                    if (q0 - u >= 0) {
                        const float prod = fm(dcv, t[u]);
                        const float nv = fa(fa(nE, prod), d[u]);
                        row[(q0 - u) * 12 + 4 + z] = nv;
                        dcv = q0 - u > 0 ? nv : prod;
                    }
            }
            // passes 2-4: the pure DD product chain, seeded with the
            // leftshift of the previous pass's final carry
            for (int j = 1; j < 4; j++) {
                float c = __shfl_down_sync(0xfu, dcv, 1);
                if (z == 3) c = 0.0f;
                for (int q0 = Q - 1; q0 >= 0 && c != 0.0f; q0 -= OV_BLK) {
                    float t[OV_BLK], d[OV_BLK];
#pragma unroll
                    for (int u = 0; u < OV_BLK; u++) {
                        const int q = max(q0 - u, 0);
                        t[u] = P.dd(q, z);
                        d[u] = row[q * 12 + 4 + z];
                    }
#pragma unroll
                    for (int u = 0; u < OV_BLK; u++)
                        if (q0 - u >= 0) {
                            c = fm(c, t[u]);
                            row[(q0 - u) * 12 + 4 + z] = fa(d[u], c);
                        }
                }
                dcv = c;
            }
        }
        __syncthreads();
        // M(q) = (M(q) + E) + D'(q) x t_md(q), D' the next stripe's
        // final D (stripe 0 leftshifted at the last); then the rescale
        {
            const float nE = sh.nE;
            float mv[OV_MAXC];
#pragma unroll
            for (int k = 0; k < OV_MAXC; k++) {
                const int c = tid + k * OV_NT;
                if (c < nc) {
                    const int q = c >> 2, z = c & 3;
                    float dsh = 0.0f;
                    if (q < Q - 1) dsh = row[(q + 1) * 12 + 4 + z];
                    else if (z < 3) dsh = row[4 + z + 1];
                    mv[k] = fa(fa(row[q * 12 + z], nE), fm(dsh, P.t(q, TMD, z)));
                }
            }
            __syncthreads();
            const int resc = sh.resc;
            const float inv = sh.inv;
            float *pl = plane + (size_t)(i - 1) * 8 * Q;
#pragma unroll
            for (int k = 0; k < OV_MAXC; k++) {
                const int c = tid + k * OV_NT;
                if (c < nc) {
                    float *cell = row + (c >> 2) * 12 + (c & 3);
                    float m = mv[k], d = cell[4], v = cell[8];
                    if (resc) {
                        m = fm(m, inv); d = fm(d, inv); v = fm(v, inv);
                        cell[4] = d; cell[8] = v;
                    }
                    cell[0] = m;
                    if (PROD) {
                        pl[c] = fm(pl[c], m);
                        pl[nc + c] = fm(pl[nc + c], v);
                    }
                }
            }
            __syncthreads();
        }
    }
    // row 0: specials only, the B fold ascending
    if (warp == 0 && lane < 4) {
        const int z = lane;
        const float *rp = P.em(codes[0]);
        const float xB = hsum4(b_fold(P, rp, row, z, false), 0xfu);
        if (lane == 0) {
            const float nN = rd(da(dm((double)xN, Nloop), dm((double)xB, Nmove)));
            xmb[XE] = 0.0f; xmb[XN] = nN; xmb[XJ] = 0.0f;
            xmb[XB] = xB; xmb[XC] = 0.0f; xmb[XS] = 1.0f;
        }
    }
    __syncthreads();
    return own;
}

struct Args {
    const float *rf, *tf;
    const int32_t *m_Q;
    const float *m_nj;
    const int64_t *m_rf, *m_tf;
    const uint8_t *codes;
    const int32_t *it_model, *it_L, *it_lseq;
    const int64_t *it_codes, *it_xmx, *it_plane;
    float *xmx_f, *xmx_b;
    int32_t *flags;
    float *null2;
    float *plane;
    int Kc;
};

__device__ Prof prof_of(const Args &a, int m) {
    Prof P;
    P.rf = a.rf + a.m_rf[m];
    P.tf = a.tf + a.m_tf[m];
    P.Q = a.m_Q[m];
    return P;
}

__global__ void __launch_bounds__(OV_NT, OV_CPS) overlay_seq_kernel(Args a) {
    extern __shared__ float row[];
    __shared__ Sh sh;
    const int it = blockIdx.x, m = a.it_model[it], L = a.it_L[it];
    const Prof P = prof_of(a, m);
    const Xf xf = length_model(a.it_lseq[it], a.m_nj[m], false);
    const uint8_t *codes = a.codes + a.it_codes[it];
    float *xmf = a.xmx_f + a.it_xmx[it] * 6;
    float *xmb = a.xmx_b + a.it_xmx[it] * 6;
    forward<false>(P, xf, codes, L, row, sh, xmf, nullptr);
    __syncthreads();
    const int own = backward<false>(P, xf, codes, L, row, sh, xmf, xmb,
                                    nullptr);
    if (threadIdx.x == 0) a.flags[it] = own;
}

__global__ void __launch_bounds__(OV_NT, OV_CPS) overlay_env_kernel(Args a) {
    extern __shared__ float row[];
    __shared__ Sh sh;
    const int it = blockIdx.x, m = a.it_model[it], L = a.it_L[it];
    const int tid = threadIdx.x;
    const Prof P = prof_of(a, m);
    const int Q = P.Q, nc = 4 * Q;
    const Xf xf = length_model(a.it_lseq[it], 0.0f, true);
    const uint8_t *codes = a.codes + a.it_codes[it];
    float *xmf = a.xmx_f + a.it_xmx[it] * 6;
    float *xmb = a.xmx_b + a.it_xmx[it] * 6;
    float *plane = a.plane + a.it_plane[it];
    forward<true>(P, xf, codes, L, row, sh, xmf, plane);
    __syncthreads();
    const int own = backward<true>(P, xf, codes, L, row, sh, xmf, xmb,
                                   plane);
    // decoding_f32 (pp = f x b x cellf, cellf = totr x SCALE(i)) and
    // null2_by_expectation_f32: row 0 = pp(1) + pp(2) + ... + pp(L) in
    // row order, x 1/L; M and I cells in parallel, rows serial
    const float totr = __fdiv_rn(1.0f, xmb[XN]);
    const float inv = __fdiv_rn(1.0f, __int2float_rn(L));
    for (int c = tid; c < 2 * nc; c += OV_NT) {
        float acc = fm(plane[c], fm(totr, xmf[6 + XS]));
#pragma unroll 4
        for (int i = 2; i <= L; i++)
            acc = fa(acc, fm(plane[(size_t)(i - 1) * 8 * Q + c],
                             fm(totr, xmf[(size_t)i * 6 + XS])));
        row[c] = fm(acc, inv);   // [M: Q x 4][I: Q x 4]
    }
    if (tid == 0) {
        // the posterior N, J and C sums: loop x f(i-1) x b(i) x totr
        float acc[3];
        const int col[3] = {XN, XJ, XC}, sp[3] = {SN, SJ, SC};
        for (int s = 0; s < 3; s++) {
            const float lp = xf.loop[sp[s]];
            acc[s] = fm(fm(fm(lp, xmf[col[s]]), xmb[6 + col[s]]), totr);
            for (int i = 2; i <= L; i++)
                acc[s] = fa(acc[s], fm(fm(fm(lp, xmf[(size_t)(i - 1) * 6 + col[s]]),
                                          xmb[(size_t)i * 6 + col[s]]), totr));
            acc[s] = fm(acc[s], inv);
        }
        // (N + C) + J
        sh.xfac = fa(fa(acc[0], acc[2]), acc[1]);
        a.flags[it] = own | ((isinf(totr) ? 1 : 0) << 1);
    }
    __syncthreads();
    // null2[x] = hsum_z(sum_q (acc + r0M x rf(x)) + r0I) + xfactor, one
    // 4-lane group a code
    const int x = tid >> 2, z = tid & 3;
    if (x < a.Kc) {
        const float *rp = P.em(x);
        float s = 0.0f;
#pragma unroll 4
        for (int q = 0; q < Q; q++)
            s = fa(fa(s, fm(row[q * 4 + z], __ldg(rp + q * 4 + z))),
                   row[nc + q * 4 + z]);
        const unsigned mask = 0xfu << (tid & 28);
        s = hsum4(s, mask);
        if (z == 0) a.null2[(size_t)it * a.Kc + x] = fa(s, sh.xfac);
    }
}

}  // namespace

// One launch of n items (launch A: env 0; launch B: env 1) on `stream`.
// Qmax: the largest Q among the items' models (the shared row).
extern "C" int witch_overlay(
        const float *rf, const float *tf, const int32_t *m_Q,
        const float *m_nj, const int64_t *m_rf, const int64_t *m_tf,
        const uint8_t *codes, const int32_t *it_model, const int32_t *it_L,
        const int32_t *it_lseq, const int64_t *it_codes,
        const int64_t *it_xmx, const int64_t *it_plane, float *xmx_f,
        float *xmx_b, int32_t *flags, float *null2, float *plane, int n,
        int Kc, int Qmax, int env, void *stream) {
    if (n <= 0) return 0;
    if (Qmax < 2 || 4 * Qmax > OV_NT * OV_MAXC || Kc > OV_NT / 4)
        return (int)cudaErrorInvalidValue;
    Args a{rf, tf, m_Q, m_nj, m_rf, m_tf, codes, it_model, it_L, it_lseq,
           it_codes, it_xmx, it_plane, xmx_f, xmx_b, flags, null2, plane,
           Kc};
    const size_t smem = (size_t)Qmax * 12 * sizeof(float);
    cudaStream_t st = (cudaStream_t)stream;
    if (env) overlay_env_kernel<<<n, OV_NT, smem, st>>>(a);
    else overlay_seq_kernel<<<n, OV_NT, smem, st>>>(a);
    return (int)cudaGetLastError();
}
