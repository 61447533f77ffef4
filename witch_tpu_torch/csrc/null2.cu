// Per-envelope null2 by expectation for the reporting gate on Hopper: one
// warp (or a group of G warps, for wide models) per envelope, several
// envelopes of one model in each CTA.
//
// Replaces: witch_tpu/ops/pallas_null2.py:_null2_kernel (the TPU kernel
// reached from null2_envelopes_device), which ran a tile of envelopes of
// one model on the vector unit and checkpointed its Forward every 32 rows
// to fit its fast memory.
//
// Computes, per envelope (model h, envelope subsequence of length Ld,
// full target length L): the isolated unihit Forward over the envelope
// with pmove = 2/(L+2) (envsc, nats), then a Backward that accumulates
// the posterior state usage: useM[k], useI = sum ppI, usetot = sum ppM +
// sum ppI, and n2dot[x] = sum_k useM[k] * em[h, x, k]. The plain version
// is ops/null2.py:null2_nats_ref; each envelope runs exactly its own
// length.
//
// What bounds it on an H100: about 45 f32 operations per DP cell (model
// state x envelope row: Forward 20, Backward 20, posterior usage 5) at
// the card's 67 TFLOP/s outside the tensor cores, and the Forward rows
// that the Backward reads back: 16 B per state-row (M and I, written once
// and read once). Rows of the envelopes in flight stay in the 50 MB L2
// only for short envelopes; long ones (a 1,400-row envelope at Mp 1,536
// holds 17 MB) go to HBM at 3.35 TB/s, and then those bytes can set the
// bound instead of the operations.
//
// Design:
// - The row lives in the lane-slot layout of common.cuh: in registers
//   (layout 0, transitions copied into shared memory once per CTA and
//   read from there every row) or in shared memory (layout 1, one
//   envelope of 8 warps per CTA, transitions in device memory, up to the
//   16,384-state cap). Per-row latency, not the operations, sets the
//   time, so the wrapper takes the fewest states per lane (the most warps
//   per envelope) that fit (ops/null2.py:n2_layout). Neither recurrence has
//   a block barrier: the delete chains are warp scans of affine maps
//   whose multipliers (products of t_dd) are loop-invariant and taken once
//   per envelope (the Backward's scan runs right to left), and the E sum,
//   the B sum and the rescale max are warp shuffles. With G > 1 the warps
//   of one envelope meet once per row at a named barrier of their own
//   threads, never the whole block.
// - The Forward is forward.cu's unihit: each row is kept unscaled and the
//   next row multiplies by 1/scale as it reads it; one meeting carries the
//   chain, the E sum, the max and the outflow across warps.
// - The Backward's rescale needs the row's max after its delete chain, so
//   the Backward is pipelined by one row: row i+1 stays unscaled until the
//   meeting of row i, which carries row i+1's max together with row i's
//   B sum and chain terms (both linear in row i+1's scale, so they are
//   taken before it is known). After the meeting, one pass per lane scales
//   row i+1, adds its posterior usage and computes row i from it.
// - The Forward rows go to device scratch in the lane-slot layout, so
//   every warp-wide store and load is 128 contiguous bytes; each envelope
//   owns Ld rows at its own offset, and each launch holds the scratch its
//   own envelopes need (ops/null2.py:plan_launches).
// - A CTA holds envelopes of one model, longest first (the wrapper's
//   plan), so its warps share the model's transitions and end together.
// - n2dot is one warp reduction per code from the registers that hold
//   useM. useI and usetot sum each row's lane terms in f32 and carry the
//   lane's running totals in f64; the scale ledgers are f64 too (as in
//   the plain version): in f32 each alone costs ~1e-4 relative over
//   ~1,400 rows.

#include "common.cuh"

#define N2_THREADS 256
#define N2_XS 8        // floats per warp in a meeting's exchange
#define N2_WS 8        // loop-invariant floats per warp

template <int NPL>
__global__ void __launch_bounds__(N2_THREADS)
    null2_kernel(const float *__restrict__ em_t, const float *__restrict__ tr_t,
                 const int32_t *__restrict__ model_of,
                 const int32_t *__restrict__ codes,
                 const int64_t *__restrict__ code_off,
                 const int32_t *__restrict__ lds,
                 const float *__restrict__ pmoves,
                 const int32_t *__restrict__ cta_env,
                 const int64_t *__restrict__ roff, float *__restrict__ rows,
                 double *__restrict__ fled, float *__restrict__ scal,
                 float *__restrict__ n2dot, int K, int G, int npl_rt,
                 int Mpad) {
    extern __shared__ float smem[];
    const int S = G * 32;                  // slot stride from j to j + 1
    const int WP = blockDim.x / S;         // envelopes in this CTA
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = warp / G, g = warp - p * G;
    const int n = NPL ? NPL : npl_rt;
    const int en = cta_env[(size_t)blockIdx.x * WP + p];
    // the plan fills a CTA's first slot and gives all its slots one model
    const int h = model_of[cta_env[(size_t)blockIdx.x * WP]];
    float *sX = smem + (NPL ? 8 * Mpad : 0);      // [2][WP][G][N2_XS]
    float *sW = sX + 2 * WP * G * N2_XS;          // [WP][G][N2_WS]
    float *sRow = sW + WP * G * N2_WS;            // layout 1: [3][Mpad]
    const float *T = tr_t + (size_t)h * 8 * Mpad;
    if (NPL) {
        const float4 *src = reinterpret_cast<const float4 *>(T);
        float4 *dst = reinterpret_cast<float4 *>(smem);
        for (int t = threadIdx.x; t < 2 * Mpad; t += blockDim.x) dst[t] = src[t];
        __syncthreads();                    // once per CTA, not per row
        T = smem;
    }
    if (en < 0) return;                     // the envelope's warps leave together
    const int Ld = lds[en];
    const int32_t *cs = codes + code_off[en];
    const float pmove = pmoves[en];
    const float ploop = 1.0f - pmove;
    const int slot0 = g * 32 + lane;
    const float *tl = T + slot0;
    const float *el = em_t + (size_t)h * K * Mpad + slot0;
    float *Rw = rows + (size_t)roff[en] * 2 * Mpad + slot0;   // row i+1 at i
    double *FL = fled + roff[en];
    float *sWp = sW + p * G * N2_WS;
    const int bar = 1 + p, nbar = S;
#define TR(r, j) tl[(r) * Mpad + (j) * S + zr]
#define XBUF(ph) (sX + (((ph) & 1) * WP + p) * G * N2_XS)

    LaneRow<NPL> row;
    row.bind(sRow + slot0, Mpad, S);
    int zr = 0;                            // see fresh_zero
    int ph = 0;                            // meetings so far (buffer parity)

    // ---- Forward invariants (forward.cu): within the lane, D at its j-th
    // state is Dloc_j + P_j c, c the chain value entering the lane,
    // P_j = prod_{t < j} t_dd; the lane passes on a_lane c + b.
    float Pj = 1.f, SP = 0.f, Plast = 1.f;
#pragma unroll
    for (int j = 0; j < (NPL ? NPL : n); ++j) {
        row.M(j) = 0.f;
        row.I(j) = 0.f;
        row.U(j) = 0.f;
        SP += Pj;
        Plast = Pj;
        Pj *= TR(T_DD, j);
    }
    float Astep[5];
    float xa = Pj;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
        const int s = 1 << t;
        const float pa = __shfl_up_sync(FULL_MASK, xa, s);
        Astep[t] = lane >= s ? xa : 0.f;
        if (lane >= s) xa = pa * xa;
    }
    float ea = __shfl_up_sync(FULL_MASK, xa, 1);   // prod of earlier lanes' a
    if (lane == 0) ea = 1.f;
    if (G > 1) {
        float se = ea * SP;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(FULL_MASK, se, o);
        const float aw = __shfl_sync(FULL_MASK, xa, 31);
        const float dl1 = __shfl_sync(FULL_MASK, ea * Plast, 31);
        if (lane == 0) {
            float *w = sWp + g * N2_WS;
            w[0] = aw;
            w[1] = se;
            w[2] = dl1;
        }
    }

    // ---- Forward, scaled rows stored ----
    // the scale ledger (log of the product of the row scales) is kept in
    // f64: over ~1,400 rows its f32 rounding alone reaches ~1e-4 of the
    // posterior usage
    float N = 1.f, B = pmove, C = 0.f, inv = 1.f;
    double logs = 0.0;
    float uin = 0.f;        // outflow of the state left of the lane's chunk
    int cw = 0;             // codes of rows (i & ~31) + lane, one per lane
    for (int i = 0; i < Ld; ++i) {
        const int zr = fresh_zero();
        if ((i & 31) == 0) cw = cs[min(i + lane, Ld - 1)];
        const float *e = el + (size_t)__shfl_sync(FULL_MASK, cw, i & 31) * Mpad;
        float b = 0.f, sM = 0.f, sD = 0.f, mx = 0.f, blast = 0.f, up = uin;
#pragma unroll
        for (int j = 0; j < (NPL ? NPL : n); ++j) {
            const float Mr = (up * inv + B * TR(T_BM, j)) * e[j * S];
            const float Ir = (row.M(j) * TR(T_MI, j) + row.I(j) * TR(T_II, j)) * inv;
            up = row.U(j);
            sD += b;
            blast = b;
            b = TR(T_DD, j) * b + TR(T_MD, j) * Mr;
            sM += Mr;
            mx = fmaxf(mx, Mr);
            row.M(j) = Mr;
            row.I(j) = Ir;
        }
        float bi = b;                      // inclusive scan of the lane maps
#pragma unroll
        for (int t = 0; t < 5; ++t) {
            const int s = 1 << t;
            const float pb = __shfl_up_sync(FULL_MASK, bi, s);
            if (lane >= s) bi = pb * Astep[t] + bi;
        }
        float eb = __shfl_up_sync(FULL_MASK, bi, 1);
        if (lane == 0) eb = 0.f;
        float E = sM + sD + eb * SP;       // with zero entering the warp
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            E += __shfl_xor_sync(FULL_MASK, E, o);
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
        }
        float Din = 0.f, uB = 0.f;
        if (G > 1) {
            float *xr = XBUF(ph++);
            if (lane == 31) {
                float *x = xr + g * N2_XS;
                x[0] = bi;
                x[1] = E;
                x[2] = mx;
                x[3] = row.M(n - 1);
                x[4] = row.I(n - 1);
                x[5] = blast + Plast * eb;
            }
            pair_barrier(bar, nbar);        // the one meeting of the row
            float D = 0.f, Et = 0.f, mt = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                const float *xg = xr + gg * N2_XS;
                const float *wg = sWp + gg * N2_WS;
                if (gg == g) Din = D;
                if (gg == g - 1) {
                    const float Dl = xg[5] + wg[2] * D;
                    const int sl = (n - 1) * S + gg * 32 + 31;
                    uB = xg[3] * T[T_MM * Mpad + sl] + xg[4] * T[T_IM * Mpad + sl] +
                         Dl * T[T_DM * Mpad + sl];
                }
                Et += xg[1] + D * wg[1];
                mt = fmaxf(mt, xg[2]);
                D = wg[0] * D + xg[0];
            }
            E = Et;
            mx = mt;
        }
        const float Cn = C * ploop + E;     // unihit: E -> C = 1
        const float Nn = N * ploop;
        const float Bn = Nn * pmove;
        const float scale = fmaxf(mx, fmaxf(Cn, fmaxf(Nn, SCALE_FLOOR)));
        const float iv = 1.0f / scale;
        N = Nn * iv;
        B = Bn * iv;
        C = Cn * iv;
        logs += (double)logf(scale);
        // pass 2: D with its true entering value, the outflow u, and the
        // scaled row to scratch
        float *Ri = Rw + (size_t)i * 2 * Mpad;
        float c = eb + ea * Din;
#pragma unroll
        for (int j = 0; j < (NPL ? NPL : n); ++j) {
            const float D = c;
            c = TR(T_DD, j) * c + TR(T_MD, j) * row.M(j);
            row.U(j) = row.M(j) * TR(T_MM, j) + row.I(j) * TR(T_IM, j) + D * TR(T_DM, j);
            Ri[j * S] = row.M(j) * iv;
            Ri[Mpad + j * S] = row.I(j) * iv;
        }
        const float ul = __shfl_up_sync(FULL_MASK, row.U(n - 1), 1);
        uin = lane ? ul : uB;
        inv = iv;
        if (g == 0 && lane == 0) FL[i] = logs;
    }
    const double envsc =
        (double)logf(fmaxf(C, SCALE_FLOOR)) + (double)logf(pmove) + logs;

    // ---- Backward invariants. Right to left, D[k] = c[k] + t_dd[k] D[k+1]
    // with c[k] = mne[k+1] t_dm[k] + bE. A lane's map takes the D entering
    // from its right; the warp's last lane takes instead
    // Z = mne[s1] t_dm[k1] + t_dd[k1] D[s1] (k1 its last state, s1 the next
    // warp's first), so that D[k1] = bE + Z and everything the warp computes
    // before its meeting is free of the next warp. D is linear in the mne
    // terms, in bE and in Z: the bE part (bc) and the multipliers are
    // invariant.
    float ab = 1.f, bc = 0.f;
#pragma unroll
    for (int j = (NPL ? NPL : n) - 1; j >= 0; --j) {
        const float t = (lane == 31 && j == n - 1) ? 1.f : TR(T_DD, j);
        bc = 1.f + t * bc;
        ab *= t;
    }
    float Bstep[5];
    float xb = ab, bci = bc;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
        const int s = 1 << t;
        const float pa = __shfl_down_sync(FULL_MASK, xb, s);
        const float pb = __shfl_down_sync(FULL_MASK, bci, s);
        const bool has = lane + s < 32;
        Bstep[t] = has ? xb : 0.f;
        if (has) {
            bci = pb * xb + bci;
            xb = xb * pa;
        }
    }
    // D entering lane l from the right = its bE part SBc * bE + SA * Z + the
    // mne part (scanned per row); lane 31 takes the true D[s1] instead
    const float SBc = __shfl_down_sync(FULL_MASK, bci, 1);
    const float SA = __shfl_down_sync(FULL_MASK, xb, 1);
    if (G > 1) {
        float *w = sWp + g * N2_WS;
        if (lane == 0) {
            w[3] = xb;                       // Z multiplier of D at the warp's first state
            w[4] = bci;                      // its bE part
        }
        if (lane == 31) {
            w[5] = TR(T_DM, n - 1);
            w[6] = TR(T_DD, n - 1);
        }
        pair_barrier(bar, nbar);             // FL and the invariants visible
    } else {
        __syncwarp();
    }

    // ---- Backward, one row behind its scale ----
#pragma unroll
    for (int j = 0; j < (NPL ? NPL : n); ++j) {
        row.M(j) = 0.f;                      // the pending row (unscaled)
        row.I(j) = 0.f;
        row.U(j) = 0.f;                      // useM from here on
    }
    float bNu = 0.f, bCu = 0.f;              // the pending row's N and C
    float bN = 0.f, bC = 0.f;
    double bled = 0.0;
    float mxp = 0.f;                         // the pending row's lane max
    // lane sums of ppM and ppI: each row's in f32, their running totals in
    // f64 (in f32 a lane's total of Ld * npl terms loses ~1e-4 relative
    // over 1,400 rows of 65 states)
    double aM = 0.0, aI = 0.0;
    for (int i = Ld; i >= 0; --i) {
        const int zr = fresh_zero();
        // row i from the pending row i+1 (none yet when i == Ld, the
        // terminal row; no new row when i == 0)
        const bool fresh = (i == Ld), newrow = (i >= 1);
        if (i < Ld && (i == Ld - 1 || (i & 31) == 31))
            cw = cs[min((i & ~31) + lane, Ld - 1)];
        const int x = __shfl_sync(FULL_MASK, cw, i & 31);
        const float *e = el + (size_t)((newrow && !fresh) ? x : 0) * Mpad;
        const double fl = fresh ? 0.0 : FL[i];   // early: used after the meeting
        float Bv = 0.f, bl = 0.f, m0 = 0.f, mr = 0.f;
        if (newrow && !fresh) {
            // pass A: mne of the pending row (unscaled), its B sum and the
            // chain's mne part with nothing entering from the right
            m0 = row.M(0) * e[0];
            mr = __shfl_down_sync(FULL_MASK, m0, 1);
            if (lane == 31) mr = 0.f;
            float mnu = mr;
#pragma unroll
            for (int j = (NPL ? NPL : n) - 1; j >= 0; --j) {
                const float mj = row.M(j) * e[j * S];
                Bv += TR(T_BM, j) * mj;
                bl = mnu * TR(T_DM, j) + TR(T_DD, j) * bl;
                mnu = mj;
            }
        }
        float bi = bl;                       // inclusive scan, right to left
#pragma unroll
        for (int t = 0; t < 5; ++t) {
            const int s = 1 << t;
            const float pb = __shfl_down_sync(FULL_MASK, bi, s);
            if (lane + s < 32) bi = pb * Bstep[t] + bi;
        }
        const float ebm = __shfl_down_sync(FULL_MASK, bi, 1);
        float mxa = mxp, Bva = Bv;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            Bva += __shfl_xor_sync(FULL_MASK, Bva, o);
            mxa = fmaxf(mxa, __shfl_xor_sync(FULL_MASK, mxa, o));
        }
        float *xr = nullptr;
        if (G > 1) {
            xr = XBUF(ph++);
            if (lane == 0) {
                float *x = xr + g * N2_XS;
                x[0] = mxa;
                x[1] = Bva;
                x[2] = bi;                   // the warp's chain, mne part
                x[3] = m0;                   // mne at the warp's first state
            }
            pair_barrier(bar, nbar);         // the one meeting of the row
            mxa = 0.f;
            Bva = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                mxa = fmaxf(mxa, xr[gg * N2_XS]);
                Bva += xr[gg * N2_XS + 1];
            }
        }
        // the pending row's scale (the terminal row is not scaled)
        float iv = 1.f;
        if (!fresh) {
            const bool term = (i + 1 == Ld);
            const float scale =
                term ? 1.f : fmaxf(mxa, fmaxf(bNu, fmaxf(bCu, SCALE_FLOOR)));
            iv = 1.0f / scale;
            bN = bNu * iv;
            bC = bCu * iv;
            bled = term ? 0.0 : bled + (double)logf(scale);
        }
        float bEn = 0.f, bNn = 0.f, bCn = 0.f;
        if (fresh) {
            bEn = pmove;
            bCn = pmove;
        } else if (newrow) {
            bNn = bN * ploop + (Bva * iv) * pmove;
            bCn = bC * ploop;
            bEn = bCn;
        }
        // the chain across warps, right to left: Z of each warp, D and
        // mne at the next warp's first state
        float Zg = 0.f, Dn1 = 0.f, mn1 = 0.f;
        if (G > 1 && newrow) {
            for (int gg = G - 1; gg >= g; --gg) {
                const float *w = sWp + gg * N2_WS;
                Zg = mn1 * w[5] + w[6] * Dn1;
                if (gg == g) break;
                const float *xg = xr + gg * N2_XS;
                Dn1 = iv * xg[2] + bEn * w[4] + w[3] * Zg;
                mn1 = iv * xg[3];
            }
        }
        float Dn = lane < 31 ? iv * ebm + bEn * SBc + SA * Zg : Dn1;
        float mnext = lane < 31 ? iv * mr : mn1;
        // pass B: scale the pending row, add its posterior usage, and
        // compute row i from it (right to left)
        const float sc = fresh ? 0.f : expf((float)(fl + bled - envsc));
        const float *Rp = Rw + (size_t)(fresh ? 0 : i) * 2 * Mpad;
        float mxn = 0.f, pM = 0.f, pI = 0.f;
#pragma unroll
        for (int j = (NPL ? NPL : n) - 1; j >= 0; --j) {
            const float bms = row.M(j) * iv, bis = row.I(j) * iv;
            if (!fresh) {
                const float ppM = Rp[j * S] * bms * sc;
                const float ppI = Rp[Mpad + j * S] * bis * sc;
                row.U(j) += ppM;
                pM += ppM;
                pI += ppI;
            }
            if (newrow) {
                const float mj = bms * e[j * S];
                const float Mi = bEn + mnext * TR(T_MM, j) + bis * TR(T_MI, j) +
                                 Dn * TR(T_MD, j);
                const float Ii = mnext * TR(T_IM, j) + bis * TR(T_II, j);
                Dn = (mnext * TR(T_DM, j) + bEn) + TR(T_DD, j) * Dn;
                mnext = mj;
                row.M(j) = Mi;
                row.I(j) = Ii;
                mxn = fmaxf(mxn, Mi);
            }
        }
        aM += (double)pM;
        aI += (double)pI;
        mxp = mxn;
        bNu = bNn;
        bCu = bCn;
    }

    // ---- useI, usetot and n2dot[x] = sum_k useM[k] em[x, k] ----
    double dI = aI, dT = aI + aM;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        dI += __shfl_xor_sync(FULL_MASK, dI, o);
        dT += __shfl_xor_sync(FULL_MASK, dT, o);
    }
    const float uI = (float)dI, uT = (float)dT;
    const int nv = 2 + K;                    // useI, usetot, then K codes
    for (int c0 = 0; c0 < nv; c0 += N2_XS) {
        float *xr = G > 1 ? XBUF(ph++) : nullptr;
        float keep[N2_XS];
#pragma unroll
        for (int v = 0; v < N2_XS; ++v) {
            float q = 0.f;
            const int x = c0 + v - 2;
            if (c0 + v == 0) {
                q = uI;
            } else if (c0 + v == 1) {
                q = uT;
            } else if (x < K) {
                const float *ex = el + (size_t)x * Mpad;
#pragma unroll
                for (int j = 0; j < (NPL ? NPL : n); ++j) q += row.U(j) * ex[j * S];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(FULL_MASK, q, o);
            }
            keep[v] = q;
            if (G > 1 && lane == 0) xr[g * N2_XS + v] = q;
        }
        if (G > 1) {
            pair_barrier(bar, nbar);
#pragma unroll
            for (int v = 0; v < N2_XS; ++v) {
                float q = 0.f;
                for (int gg = 0; gg < G; ++gg) q += xr[gg * N2_XS + v];
                keep[v] = q;
            }
        }
        if (g == 0 && lane == 0) {
#pragma unroll
            for (int v = 0; v < N2_XS; ++v) {
                const int u = c0 + v;
                if (u < 2)
                    scal[(size_t)en * 3 + 1 + u] = keep[v];
                else if (u < nv)
                    n2dot[(size_t)en * 128 + (u - 2)] = keep[v];
            }
        }
    }
    if (g == 0 && lane == 0) scal[(size_t)en * 3] = (float)envsc;
#undef TR
#undef XBUF
}

static size_t smem_bytes(bool regs, int WP, int G, int Mpad) {
    return ((size_t)2 * WP * G * N2_XS + (size_t)WP * G * N2_WS +
            (size_t)(regs ? 8 : 3) * Mpad) * sizeof(float);
}

static int warps_per_envelope_cta(int G) {
    return N2_THREADS / (32 * G) > 0 ? N2_THREADS / (32 * G) : 1;
}

template <int NPL>
static int launch(const float *em_t, const float *tr_t, const int32_t *model_of,
                  const int32_t *codes, const int64_t *code_off,
                  const int32_t *lds, const float *pmoves,
                  const int32_t *cta_env, const int64_t *roff, float *rows,
                  double *fled, float *scal, float *n2dot, int ncta, int K,
                  int G, int npl, int Mpad, cudaStream_t stream) {
    const int WP = warps_per_envelope_cta(G);
    const int threads = WP * G * 32;
    if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = smem_bytes(NPL > 0, WP, G, Mpad);
    cudaError_t err = set_smem((const void *)null2_kernel<NPL>, smem);
    if (err != cudaSuccess) return (int)err;
    if (ncta > 0)
        null2_kernel<NPL><<<(unsigned)ncta, threads, smem, stream>>>(
            em_t, tr_t, model_of, codes, code_off, lds, pmoves, cta_env, roff,
            rows, fled, scal, n2dot, K, G, npl, Mpad);
    return (int)cudaGetLastError();
}

template <int NPL>
static int occupancy(int G, int Mpad, int *ctas) {
    const int WP = warps_per_envelope_cta(G);
    const size_t smem = smem_bytes(NPL > 0, WP, G, Mpad);
    cudaError_t err = set_smem((const void *)null2_kernel<NPL>, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, null2_kernel<NPL>, WP * G * 32, smem);
}

// layout 0: npl in {8, 16, 24, 32}, the row in registers;
// layout 1: any npl, the row in shared memory. ncta CTAs of
// 256 / (32 G) envelopes each (cta_env, -1 for an empty slot). Returns a
// cudaError_t code.
extern "C" int witch_null2(const float *em_t, const float *tr_t,
                           const int32_t *model_of, const int32_t *codes,
                           const int64_t *code_off, const int32_t *lds,
                           const float *pmoves, const int32_t *cta_env,
                           const int64_t *roff, float *rows, double *fled,
                           float *scal, float *n2dot, int ncta, int K,
                           int layout, int G, int npl, int Mpad, void *stream) {
    if (Mpad != 32 * G * npl || K > 128) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define N2_LAUNCH(NPL_)                                                        \
    launch<NPL_>(em_t, tr_t, model_of, codes, code_off, lds, pmoves, cta_env,  \
                 roff, rows, fled, scal, n2dot, ncta, K, G, npl, Mpad, st)
    if (layout == 0) {
        switch (npl) {
        case 8: return N2_LAUNCH(8);
        case 16: return N2_LAUNCH(16);
        case 24: return N2_LAUNCH(24);
        case 32: return N2_LAUNCH(32);
        default: return (int)cudaErrorInvalidValue;
        }
    }
    if (layout == 1) return N2_LAUNCH(0);
#undef N2_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// CTAs of the layout that one SM keeps resident, into *ctas. Returns a
// cudaError_t code.
extern "C" int witch_null2_ctas_per_sm(int layout, int G, int npl, int Mpad,
                                       int *ctas) {
    if (layout == 1) return occupancy<0>(G, Mpad, ctas);
    if (layout != 0) return (int)cudaErrorInvalidValue;
    switch (npl) {
    case 8: return occupancy<8>(G, Mpad, ctas);
    case 16: return occupancy<16>(G, Mpad, ctas);
    case 24: return occupancy<24>(G, Mpad, ctas);
    case 32: return occupancy<32>(G, Mpad, ctas);
    default: return (int)cudaErrorInvalidValue;
    }
}
