// Multihit flank posterior rows for the reporting-gate prefilter
// (--full-search-results) on Hopper, over an all-vs-all grid of (model,
// query) pairs.
//
// Replaces: witch_tpu/hmm/flank_device.py:_flank_one (vmapped by
// flank_rows_bank; XLA scans, not a Pallas kernel), the device half of
// prefilter_grid.
//
// Per pair: a multihit Forward over the query, rescaled per row by
// max(max M, C, N) with a 1e-35 floor, storing each row's log specials
// (with the running log scale); then the Backward from the terminal row L
// down to row 0 with the same rescale, combining each row's log specials
// with the stored Forward ones into
//   ppB[i] = exp(fB[i] + bB[i] - fwd),  ppE[i] = exp(fE[i] + bE[i] - fwd),
//   mocc[i] = 1 - (ppN + ppJ + ppC)[i],  ppX[i] = exp(fX[i-1] + ln loop
//             + bX[i] - fwd),
// with numpy.nan_to_num semantics, rows past the query length zeroed
// (flank_device.py:182-197). Row arithmetic is f32 as on the TPU; the
// plain version is ops/flank.py:flank_rows_ref.
//
// What bounds it on an H100: about 40 f32 operations per DP cell (model
// state x query row: the Forward's 20 and the Backward's 20) at the
// card's 67 TFLOP/s outside the tensor cores; its bytes (the outputs,
// 12 B per row of the padded query length, and the stored specials,
// 20 B per row written and read back) take ~40x less at 3.35 TB/s on the
// bench grid (tools/flank_bench.py). The grid is dense (tens of thousands
// of pairs), so the card's issue rate, not one pair's per-row latency,
// sets the time, as for forward.cu: more warps a pair lose wherever the
// grid fills the card (flank_bench.py --layouts).
//
// Two layouts of one kernel, picked by width (ops/flank.py:flank_layout),
// and the first version, kept for timing (first_version=True; no path
// takes it):
//
// flank_warp_kernel: one warp, or G warps for wide models, per pair, and
// several pairs of one model per CTA, the row in registers in the lane-slot
// layout of common.cuh (state k = (g*32 + lane)*npl + j at slot
// (j*G + g)*32 + lane); the model's transitions copied into shared memory
// once per CTA. Every width whose transitions fit there (Mpad up to
// 6,400: bank widths up to Mp 6,304): every bank of amino500's, dna1k's
// and the bench grid's.
// - Forward: as forward.cu's. With G = 1 a row has no barrier: the delete
//   chain is a warp scan of affine maps whose multipliers (products of
//   t_dd) are taken once per pair, and the E sum and the rescale max are
//   shuffles. With G > 1 the pair's warps meet once a row at a named
//   barrier of their own threads.
// - Backward, one meeting a row. Its delete chain
//   D[k] = c[k] + E + t_dd[k] D[k+1], c[k] = mne[k+1] t_dm[k], is linear
//   in the row's E state, which needs the row's B sum: D = D_c + E D_1,
//   with D_1 a per-model invariant (ops/flank.py:flank_tables, d1_t). So
//   a lane runs its part of the c chain before E is known, and the row's
//   one exchange carries the chain carries together with the partial B
//   sum. The rescale needs the finished row's max, so the Backward is
//   pipelined by one row: row i+1 stays unscaled until the meeting of row
//   i, which carries its max as well (everything taken from it before the
//   meeting is linear in its scale). The terminal row is D_L = E_L D_1.
// - Stored specials: a record of 5 floats per row, record i holding what
//   the combine of row i reads, (fN fJ fC)[i-1] and (fB fE)[i]; lanes 0-4
//   write one each in the Forward and read one each in the Backward, and
//   spread the row's logs and exps. Each pair's records lie at its own
//   offset of the launch's scratch (ops/flank.py:spec_floats).
// - Outputs: the combined rows are staged in registers, lane (r & 31)
//   holding output index r, and stored 32 at a time, one 128-byte line per
//   array whenever the pair's rows cover it.
// - The wrapper sorts the queries longest first (ops/flank.py:cta_queries),
//   so the pairs of a CTA end together; each writes at its own [q, h].
//
// The cluster instance (flank_warp_kernel<NPL, true>, layout 1), from
// bank width Mp 6,432 up to the 16,384-state cap: the same design over a
// thread-block cluster. A pair's G = 8 C warps lie on C CTAs of 8 warps
// (C 2 and 16 states a lane at dnawide's Mp 7,072 and 7,200; C 3 and 24 at
// Mp 16,416), one pair a cluster. Each CTA copies only its own slice of
// the tables (8 x 256 npl floats of transitions; ops/flank.py:
// flank_tables lays them out per CTA in the slot layout of its 256
// lanes), which is what the warp-per-pair kernel could not fit: a whole
// model's 8 x Mpad floats in one CTA. The row's one meeting, Forward and
// Backward alike, goes through distributed shared memory: each warp
// pushes its record (the Forward's delete-chain carry, E sum and max;
// the Backward's max, B sum, D_c and mne at its first state) into the
// same double-buffered slot of every CTA (lane r < C stores rank r's
// copy), then the cluster crosses one barrier (barrier.cluster arrive
// with release, wait with acquire) and every CTA reads all records from
// its own shared memory. The loop-invariant multipliers go out the same
// way once, with each warp's last-state transitions, which the warp
// above needs (its outflow and the Backward's X) and which another CTA
// may hold. The stored specials and the outputs stay per pair (its first
// warp, in the cluster's first CTA). A meeting costs ~0.4-0.5 us alone
// and 1-2 us with the exchange at these cluster sizes (phase 2h of
// chip_smoke.py, ops/cluster.py), against the first version's dozen
// block barriers and per-thread chunk loops a row.
//
// flank_kernel, the first version: one CTA of 256 threads per pair, the
// rows (3 * Mp floats, 197 KB at Mp 16,416) in shared memory and updated
// in place with the block-wide row helpers of common.cuh, a block barrier
// on every row.

#include <float.h>
#include <math.h>

#include "cluster.cuh"
#include "common.cuh"

static constexpr float FLANK_FLOOR = 1e-35f;   // flank_device.py:93,143

#define FL_THREADS 256
#define FL_XS 8          // floats per warp of a row's exchange
#define FL_WS 4          // loop-invariant floats per warp
#define FL_WS_C 8        // the same in the cluster instance, with the last
                         // state's t_mm, t_im, t_dm and t_dd (another CTA
                         // may hold them)
#define FL_SPEC 5        // stored specials per row

// numpy.nan_to_num for f32: NaN -> 0, +-inf -> +-FLT_MAX
static __device__ __forceinline__ float nan0(float x) {
    if (isnan(x)) return 0.f;
    if (isinf(x)) return x > 0.f ? FLT_MAX : -FLT_MAX;
    return x;
}

template <int NPL, bool kC>
__global__ void __launch_bounds__(FL_THREADS)
    flank_warp_kernel(const float *__restrict__ em_t,
                      const float *__restrict__ tr_t,
                      const float *__restrict__ d1_t,
                      const int32_t *__restrict__ codes,
                      const int32_t *__restrict__ qlens,
                      const int32_t *__restrict__ slots,
                      float *__restrict__ fwd_out, float *__restrict__ ppB,
                      float *__restrict__ ppE, float *__restrict__ mocc,
                      float *__restrict__ fspec, int H, int K, int Lstride,
                      int W, int G, int Mpad, int nC) {
    extern __shared__ float smem[];
    constexpr int WS = kC ? FL_WS_C : FL_WS;
    const int S = G * 32;                  // lanes of a pair
    const int WP = kC ? 1 : blockDim.x / S;   // pairs in this CTA (cluster)
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rank = kC ? cluster_rank() : 0;
    const int p = kC ? 0 : warp / G;
    const int g = kC ? rank * (FL_THREADS / 32) + warp : warp - p * G;
    const int cta = kC ? blockIdx.x / nC : blockIdx.x;
    const int h = cta % H;
    const int sl = (cta / H) * WP + p;             // the pair's query slot
    // the slots this CTA holds: all the pair's, or in the cluster instance
    // its own 256 lanes' (ST from j to j + 1; ops/flank.py:flank_slot_index)
    const int ST = kC ? FL_THREADS : S;
    const int MT = kC ? Mpad / nC : Mpad;
    float *sX = smem + 8 * MT;                     // [2][WP][G][FL_XS]
    float *sW = sX + 2 * WP * G * FL_XS + p * G * WS;   // [G][WS]
    {
        const float4 *src = reinterpret_cast<const float4 *>(
            tr_t + (size_t)h * 8 * Mpad + (size_t)rank * 8 * MT);
        float4 *dst = reinterpret_cast<float4 *>(smem);
        for (int t = threadIdx.x; t < 2 * MT; t += blockDim.x) dst[t] = src[t];
        __syncthreads();                    // once per CTA, not per row
        if constexpr (kC) cluster_meet();   // every CTA started: DSMEM is live
    }
    const int q = slots[sl];
    if (q < 0) return;                      // the pair's warps leave together
    const float *T = smem;
    const int L = qlens[q];
    const int32_t *cq = codes + (size_t)q * Lstride;
    const int v = g * 32 + lane;            // the lane's chunk of states
    const int vl = kC ? warp * 32 + lane : v;   // its slot in this CTA
    const float *tl = T + vl;
    const float *el = em_t + (size_t)h * K * Mpad + (size_t)rank * MT + vl;
    const bool lead = g == 0;               // writes the pair's outputs
    const size_t rbase = ((size_t)q * H + h) * W;  // the pair's output row
    float *FS = fspec + ((size_t)sl * H + h) * (size_t)(FL_SPEC * (Lstride + 2));
    const int bar = 1 + p;
#define TR(r, j) tl[(r) * MT + (j) * ST]
#define XB(ph) (sX + (((ph) & 1) * WP + p) * G * FL_XS)
    int ph = 0;                             // meetings so far (buffer parity)

    const float pmove = 3.0f / ((float)L + 3.0f);
    const float ploop = 1.0f - pmove;
    if (lead) {
        for (size_t r = rbase + L + 1 + lane; r < rbase + W; r += 32) {
            ppB[r] = 0.f;
            ppE[r] = 0.f;
            mocc[r] = 0.f;
        }
        // record 0: fB[0] = ln pmove, fE[0] = -inf (its N J C unused);
        // record 1: fN[0] = 0, fJ[0] = fC[0] = -inf
        if (lane < FL_SPEC) FS[lane] = lane == 3 ? logf(pmove) : -INFINITY;
        if (lane < 3) FS[FL_SPEC + lane] = lane == 0 ? 0.f : -INFINITY;
    }

    LaneRow<NPL> row;
    // ---- Forward invariants. Within the lane, D at its j-th state is
    // its local chain plus Pj times the D entering the lane; the lane's
    // map multiplies what enters by a = prod t_dd.
    float Pj = 1.f, SP = 0.f, Plast = 1.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
        row.M(j) = 0.f;
        row.I(j) = 0.f;
        row.U(j) = 0.f;
        SP += Pj;
        Plast = Pj;
        Pj *= TR(T_DD, j);
    }
    float Astep[5];                         // left-to-right scan multipliers
    float xa = Pj;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
        const int s = 1 << t;
        const float pa = __shfl_up_sync(FULL_MASK, xa, s);
        Astep[t] = lane >= s ? xa : 0.f;
        if (lane >= s) xa *= pa;
    }
    float ea = __shfl_up_sync(FULL_MASK, xa, 1);   // prod of earlier lanes' a
    if (lane == 0) ea = 1.f;
    if (G > 1) {
        // the warp's map multiplier, the E sum's and its last state's D's
        // sensitivity to the D entering the warp
        float se = ea * SP;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(FULL_MASK, se, o);
        const float aw = __shfl_sync(FULL_MASK, xa, 31);
        const float dl = __shfl_sync(FULL_MASK, ea * Plast, 31);
        if constexpr (kC) {
            float *w = sW + g * WS;
            put_all_uniform(w + 0, aw, nC);
            put_all_uniform(w + 1, se, nC);
            put_all_uniform(w + 2, dl, nC);
            put_all(w + 4, TR(T_MM, NPL - 1), 31, nC);
            put_all(w + 5, TR(T_IM, NPL - 1), 31, nC);
            put_all(w + 6, TR(T_DM, NPL - 1), 31, nC);
            put_all(w + 7, TR(T_DD, NPL - 1), 31, nC);
        } else if (lane == 0) {
            sW[g * FL_WS + 0] = aw;
            sW[g * FL_WS + 1] = se;
            sW[g * FL_WS + 2] = dl;
        }
    }

    // ---- Forward, the rows' log specials stored ----
    float N = 1.f, B = pmove, J = 0.f, C = 0.f, logs = 0.f, inv = 1.f;
    float uin = 0.f;        // outflow of the state left of the lane's chunk
    int cw = 0;             // codes of rows (i & ~31) + lane
    for (int i = 0; i < L; ++i) {
        if ((i & 31) == 0) cw = cq[min(i + lane, L - 1)];
        const float *e = el + (size_t)__shfl_sync(FULL_MASK, cw, i & 31) * Mpad;
        // pass 1: M and I of DP row i + 1 from row i (scaled as read), the
        // lane's chain with nothing entering, its sums and max
        float b = 0.f, sM = 0.f, sD = 0.f, mx = 0.f, blast = 0.f, up = uin;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
            const float Mr = (up * inv + B * TR(T_BM, j)) * e[j * ST];
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
        float bi = b;                       // inclusive scan of the lane maps
#pragma unroll
        for (int t = 0; t < 5; ++t) {
            const float pb = __shfl_up_sync(FULL_MASK, bi, 1 << t);
            if (lane >= (1 << t)) bi = pb * Astep[t] + bi;
        }
        float eb = __shfl_up_sync(FULL_MASK, bi, 1);
        if (lane == 0) eb = 0.f;
        float E = sM + sD + eb * SP;        // with nothing entering the warp
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            E += __shfl_xor_sync(FULL_MASK, E, o);
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
        }
        float Din = 0.f, uB = 0.f;
        if (G > 1) {
            float *xr = XB(ph++);
            float *x = xr + g * FL_XS;
            if constexpr (kC) {
                put_all(x + 0, bi, 31, nC);
                put_all_uniform(x + 1, E, nC);
                put_all_uniform(x + 2, mx, nC);
                put_all(x + 3, row.M(NPL - 1), 31, nC);
                put_all(x + 4, row.I(NPL - 1), 31, nC);
                put_all(x + 5, blast + Plast * eb, 31, nC);
                cluster_meet();             // the one meeting of the row
            } else {
                if (lane == 31) {
                    x[0] = bi;              // the D leaving the warp
                    x[1] = E;
                    x[2] = mx;
                    x[3] = row.M(NPL - 1);
                    x[4] = row.I(NPL - 1);
                    x[5] = blast + Plast * eb;   // D at the warp's last state
                }
                pair_barrier(bar, S);       // the one meeting of the row
            }
            float D = 0.f, Et = 0.f, mt = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                const float *xg = xr + gg * FL_XS;
                const float *wg = sW + gg * WS;
                if (gg == g) Din = D;
                if (gg == g - 1) {          // the outflow of its last state
                    if constexpr (kC) {
                        uB = xg[3] * wg[4] + xg[4] * wg[5] + (xg[5] + wg[2] * D) * wg[6];
                    } else {
                        const int sk = (NPL - 1) * S + gg * 32 + 31;
                        uB = xg[3] * T[T_MM * Mpad + sk] + xg[4] * T[T_IM * Mpad + sk] +
                             (xg[5] + wg[2] * D) * T[T_DM * Mpad + sk];
                    }
                }
                Et += xg[1] + D * wg[1];
                mt = fmaxf(mt, xg[2]);
                D = wg[0] * D + xg[0];
            }
            E = Et;
            mx = mt;
        }
        const float Jn = J * ploop + E * 0.5f;
        const float Cn = C * ploop + E * 0.5f;
        const float Nn = N * ploop;
        const float Bn = Nn * pmove + Jn * pmove;
        if (lead && lane < FL_SPEC) {
            // N J C of row i + 1 to record i + 2, its B E to record i + 1
            const float val = lane == 0 ? Nn : lane == 1 ? Jn : lane == 2 ? Cn
                              : lane == 3 ? Bn : E;
            FS[(lane < 3 ? i + 2 : i + 1) * FL_SPEC + lane] = logf(val) + logs;
        }
        const float scale = fmaxf(fmaxf(mx, fmaxf(Cn, Nn)), FLANK_FLOOR);
        const float iv = 1.0f / scale;
        N = Nn * iv;
        B = Bn * iv;
        J = Jn * iv;
        C = Cn * iv;
        logs += logf(scale);
        // pass 2: D with its true entering value, and the outflow u
        float c = eb + ea * Din;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
            const float D = c;
            c = TR(T_DD, j) * c + TR(T_MD, j) * row.M(j);
            row.U(j) = row.M(j) * TR(T_MM, j) + row.I(j) * TR(T_IM, j) + D * TR(T_DM, j);
        }
        const float ul = __shfl_up_sync(FULL_MASK, row.U(NPL - 1), 1);
        uin = lane ? ul : uB;
        inv = iv;
    }
    const float fwd = logf(C * pmove) + logs;
    if (lead && lane == 0) fwd_out[(size_t)q * H + h] = fwd;
    const float log_loop = logf(ploop);

    // ---- Backward invariants. Right to left, a lane's map takes the D_c
    // entering from its right; the warp's last lane leaves out its last
    // state's t_dd, so that everything before the meeting is free of the
    // next warp: the warp's last state then holds
    // X = t_dm mne[s1] + t_dd D_c[s1] (s1 the next warp's first state),
    // and the D_c entering lane l < 31 is its scan term plus dX X.
    float ab = 1.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j)
        if (lane < 31 || j < NPL - 1) ab *= TR(T_DD, j);
    float Bstep[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) {
        const int s = 1 << t;
        const float pa = __shfl_down_sync(FULL_MASK, ab, s);
        Bstep[t] = lane + s < 32 ? ab : 0.f;
        if (lane + s < 32) ab *= pa;
    }
    // ab is now the product from the lane's first state to the warp's
    // last but one: the sensitivity of D_c there to X
    float dX = __shfl_down_sync(FULL_MASK, ab, 1);
    if (lane == 31) dX = 0.f;
    // visible at the first meeting; D_1 at the next lane's first state
    float d1r;
    if constexpr (kC) {
        put_all(sW + g * WS + 3, ab, 0, nC);
        d1r = d1_t[(size_t)h * S + v];      // ops/flank.py:flank_tables
    } else {
        if (G > 1 && lane == 0) sW[g * FL_WS + 3] = ab;
        d1r = v + 1 < S ? d1_t[(size_t)h * Mpad + v + 1] : 0.f;
    }

    // ---- terminal row L: D_L = E_L D_1, M_L[k] = E_L + D_L[k+1] t_md[k],
    // M_L[0] = 0, I_L = 0 (flank_device.py:155-162)
    const float EL = pmove * 0.5f;
    {
        float d1 = d1r;
#pragma unroll
        for (int j = NPL - 1; j >= 0; --j) {
            row.M(j) = EL + EL * d1 * TR(T_MD, j);
            row.I(j) = 0.f;
            d1 = 1.f + TR(T_DD, j) * d1;
        }
        if (v == 0) row.M(0) = 0.f;
    }

    // row i's combine on lanes 0-4 of the pair's first warp: fs is record
    // i's slot, lb the Backward log special of the same lane's term; the
    // results are staged and stored a 128-byte line at a time
    float sB = 0.f, sE = 0.f, sO = 0.f;
    auto combine = [&](int i, float fs, float lb) {
        float t = 0.f;
        if (lane < FL_SPEC)
            t = nan0(expf(fs + (lane < 3 ? log_loop : 0.f) + lb - fwd));
        const float tN = __shfl_sync(FULL_MASK, t, 0);
        const float tJ = __shfl_sync(FULL_MASK, t, 1);
        const float tC = __shfl_sync(FULL_MASK, t, 2);
        const float tB = __shfl_sync(FULL_MASK, t, 3);
        const float tE = __shfl_sync(FULL_MASK, t, 4);
        const size_t r = rbase + i;
        if (lane == (int)(r & 31)) {
            sB = tB;
            sE = tE;
            sO = i >= 1 ? 1.0f - (tN + tJ + tC) : 0.f;
        }
        if ((r & 31) == 0 || i == 0) {
            const size_t a = (r & ~(size_t)31) + lane;
            if (a >= r && a <= rbase + L) {
                ppB[a] = sB;
                ppE[a] = sE;
                mocc[a] = sO;
            }
        }
    };
    if (lead) {
        // row L: N = J = B = -inf, C = move, E = move * e_move
        const float fs = lane < FL_SPEC ? FS[L * FL_SPEC + lane] : 0.f;
        combine(L, fs, lane == 2 ? logf(pmove)
                       : lane == 4 ? logf(pmove) + logf(0.5f) : -INFINITY);
    }

    // ---- Backward, one row behind its scale ----
    float Nu = 0.f, Ju = 0.f, Cu = pmove;   // the pending row's specials
    float mxp = 0.f;                        // the pending row's lane max
    float blogs = 0.f;
    for (int i = L - 1; i >= 0; --i) {
        if (i == L - 1 || (i & 31) == 31) cw = cq[min((i & ~31) + lane, L - 1)];
        const float *e = el + (size_t)__shfl_sync(FULL_MASK, cw, i & 31) * Mpad;
        const float fs = lead && lane < FL_SPEC ? FS[i * FL_SPEC + lane] : 0.f;
        // pass A: mne of the pending row i + 1 (unscaled), its B sum, and
        // the lane's D_c chain with nothing entering
        const float m0 = row.M(0) * e[0];
        float mr = __shfl_down_sync(FULL_MASK, m0, 1);
        if (lane == 31) mr = 0.f;
        float Bu = 0.f, bl = 0.f, mn = mr;
#pragma unroll
        for (int j = NPL - 1; j >= 0; --j) {
            const float mj = row.M(j) * e[j * ST];
            Bu += TR(T_BM, j) * mj;
            bl = mn * TR(T_DM, j) + TR(T_DD, j) * bl;
            mn = mj;
        }
        float bi = bl;                      // inclusive scan, right to left
#pragma unroll
        for (int t = 0; t < 5; ++t) {
            const float pb = __shfl_down_sync(FULL_MASK, bi, 1 << t);
            if (lane + (1 << t) < 32) bi += Bstep[t] * pb;
        }
        const float ebm = __shfl_down_sync(FULL_MASK, bi, 1);
        float mxa = mxp, Bva = Bu;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            Bva += __shfl_xor_sync(FULL_MASK, Bva, o);
            mxa = fmaxf(mxa, __shfl_xor_sync(FULL_MASK, mxa, o));
        }
        float Dcin = lane < 31 ? ebm : 0.f, min_ = mr;
        if (G > 1) {
            float *xr = XB(ph++);
            float *x = xr + g * FL_XS;
            if constexpr (kC) {
                put_all_uniform(x + 0, mxa, nC);
                put_all_uniform(x + 1, Bva, nC);
                put_all(x + 2, bi, 0, nC);
                put_all(x + 3, m0, 0, nC);
                cluster_meet();             // the one meeting of the row
            } else {
                if (lane == 0) {
                    x[0] = mxa;
                    x[1] = Bva;
                    x[2] = bi;              // D_c at the warp's first state
                    x[3] = m0;              // mne there
                }
                pair_barrier(bar, S);       // the one meeting of the row
            }
            mxa = 0.f;
            Bva = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                mxa = fmaxf(mxa, xr[gg * FL_XS]);
                Bva += xr[gg * FL_XS + 1];
            }
            // D_c and mne at the first state of warp g + 1, right to left
            float Dn = 0.f, mnx = 0.f;
            for (int gg = G - 1; gg > g; --gg) {
                float X;
                if constexpr (kC) {
                    X = sW[gg * WS + 6] * mnx + sW[gg * WS + 7] * Dn;
                } else {
                    const int sk = (NPL - 1) * S + gg * 32 + 31;
                    X = T[T_DM * Mpad + sk] * mnx + T[T_DD * Mpad + sk] * Dn;
                }
                Dn = xr[gg * FL_XS + 2] + sW[gg * WS + 3] * X;
                mnx = xr[gg * FL_XS + 3];
            }
            float X;
            if constexpr (kC) {
                X = sW[g * WS + 6] * mnx + sW[g * WS + 7] * Dn;
            } else {
                const int sk = (NPL - 1) * S + g * 32 + 31;
                X = T[T_DM * Mpad + sk] * mnx + T[T_DD * Mpad + sk] * Dn;
            }
            Dcin = lane < 31 ? ebm + dX * X : Dn;
            if (lane == 31) min_ = mnx;
        }
        // the pending row's scale (the terminal row is not scaled)
        float iv = 1.f;
        if (i < L - 1) {
            const float scale = fmaxf(fmaxf(mxa, fmaxf(Nu, Cu)), FLANK_FLOOR);
            iv = 1.0f / scale;
            blogs += logf(scale);
        }
        const float Bv = Bva * iv;
        const float Ni = Nu * iv * ploop + Bv * pmove;
        const float Ji = Ju * iv * ploop + Bv * pmove;
        const float Ci = Cu * iv * ploop;
        const float Ei = Ci * 0.5f + Ji * 0.5f;
        if (lead) {
            const float x = lane == 0 ? Ni : lane == 1 ? Ji : lane == 2 ? Ci
                            : lane == 3 ? Bv : Ei;
            combine(i, fs, lane < FL_SPEC ? logf(x) + blogs : 0.f);
        }
        if (i == 0) break;                  // row 0's M and I are not needed
        // pass B: row i from the scaled row i + 1, right to left (mne
        // taken again from the pending row, which is not kept beside it:
        // two rows of registers in the Backward, not three)
        float Dn = iv * Dcin + Ei * d1r;    // D[k + 1] entering the lane
        float mnext = iv * min_;            // mne[k + 1]
        float mx = 0.f;
#pragma unroll
        for (int j = NPL - 1; j >= 0; --j) {
            const float bis = row.I(j) * iv;
            const float Mi = Ei + mnext * TR(T_MM, j) + bis * TR(T_MI, j) +
                             Dn * TR(T_MD, j);
            const float Ii = mnext * TR(T_IM, j) + bis * TR(T_II, j);
            Dn = mnext * TR(T_DM, j) + Ei + TR(T_DD, j) * Dn;
            mnext = row.M(j) * e[j * ST] * iv;
            row.M(j) = Mi;
            row.I(j) = Ii;
            mx = fmaxf(mx, Mi);
        }
        mxp = mx;
        Nu = Ni;
        Ju = Ji;
        Cu = Ci;
    }
#undef TR
#undef XB
    if constexpr (kC) cluster_meet();       // no CTA leaves while others write to it
}

template <int NPL>
static int launch_warp(const float *em_t, const float *tr_t, const float *d1_t,
                       const int32_t *codes, const int32_t *qlens,
                       const int32_t *slots, float *fwd, float *ppB, float *ppE,
                       float *mocc, float *fspec, int H, int n_groups, int K,
                       int Lstride, int W, int G, int Mpad, cudaStream_t st) {
    const int WP = FL_THREADS / (32 * G) > 0 ? FL_THREADS / (32 * G) : 1;
    const int threads = WP * G * 32;
    if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(float) * ((size_t)8 * Mpad + (size_t)2 * WP * G * FL_XS +
                                         (size_t)WP * G * FL_WS);
    cudaError_t err = set_smem((const void *)flank_warp_kernel<NPL, false>, smem);
    if (err != cudaSuccess) return (int)err;
    flank_warp_kernel<NPL, false><<<(unsigned)((size_t)n_groups * H), threads, smem, st>>>(
        em_t, tr_t, d1_t, codes, qlens, slots, fwd, ppB, ppE, mocc, fspec, H, K,
        Lstride, W, G, Mpad, 1);
    return (int)cudaGetLastError();
}

static size_t cluster_smem(int G, int MT) {
    return sizeof(float) * ((size_t)8 * MT + (size_t)2 * G * FL_XS + (size_t)G * FL_WS_C);
}

template <int NPL>
static int launch_cluster_flank(const float *em_t, const float *tr_t, const float *d1_t,
                                const int32_t *codes, const int32_t *qlens,
                                const int32_t *slots, float *fwd, float *ppB, float *ppE,
                                float *mocc, float *fspec, int H, int n_groups, int K,
                                int Lstride, int W, int C, int Mpad, cudaStream_t st) {
    const int G = 8 * C;
    const size_t smem = cluster_smem(G, Mpad / C);
    cudaError_t err = set_smem((const void *)flank_warp_kernel<NPL, true>, smem);
    if (err != cudaSuccess) return (int)err;
    err = launch_cluster(flank_warp_kernel<NPL, true>, n_groups * H, C, FL_THREADS, smem, st,
                         em_t, tr_t, d1_t, codes, qlens, slots, fwd, ppB, ppE, mocc, fspec,
                         H, K, Lstride, W, G, Mpad, C);
    return (int)err;
}

// The cluster instance: one pair per cluster of C CTAs of 8 warps (G = 8 C
// warps a pair, the slot layout of each CTA's 256 lanes, its own slice of
// the tables: ops/flank.py:flank_tables), npl in {8, 16, 24}; n_groups
// query slots (one pair a slot) times the H models. Refused (an error
// code) when no such cluster fits on the card at once.
extern "C" int witch_flank_cluster(const float *em_t, const float *tr_t,
                                   const float *d1_t, const int32_t *codes,
                                   const int32_t *qlens, const int32_t *slots,
                                   float *fwd, float *ppB, float *ppE, float *mocc,
                                   float *fspec, int H, int n_groups, int K,
                                   int Lstride, int W, int C, int npl, int Mpad,
                                   void *stream) {
    if (H <= 0 || n_groups <= 0) return 0;
    if (C < 2 || C > 8 || Mpad != 32 * 8 * C * npl) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define FL_ARGS em_t, tr_t, d1_t, codes, qlens, slots, fwd, ppB, ppE, mocc, \
                fspec, H, n_groups, K, Lstride, W, C, Mpad, st
    switch (npl) {
    case 8: return launch_cluster_flank<8>(FL_ARGS);
    case 16: return launch_cluster_flank<16>(FL_ARGS);
    case 24: return launch_cluster_flank<24>(FL_ARGS);
    default: return (int)cudaErrorInvalidValue;
    }
#undef FL_ARGS
}

// Clusters of the cluster instance (C CTAs, npl states a lane) the card
// holds at once, or -error.
extern "C" int witch_flank_cluster_active(int C, int npl) {
    const size_t smem = cluster_smem(8 * C, 256 * npl);
    const void *fn = npl == 8    ? (const void *)flank_warp_kernel<8, true>
                     : npl == 16 ? (const void *)flank_warp_kernel<16, true>
                                 : (const void *)flank_warp_kernel<24, true>;
    cudaError_t err = set_smem(fn, smem);
    if (err != cudaSuccess) return -(int)err;
    return npl == 8    ? max_active_clusters(flank_warp_kernel<8, true>, C, FL_THREADS, smem)
           : npl == 16 ? max_active_clusters(flank_warp_kernel<16, true>, C, FL_THREADS, smem)
                       : max_active_clusters(flank_warp_kernel<24, true>, C, FL_THREADS, smem);
}

// The warp-per-pair kernel on n_groups groups of query slots (slots
// points at the launch's first; FL_THREADS / (32 G) slots a group) times
// the H models; npl in {8, 16, 24, 32, 40, 48}. Returns a cudaError_t code.
extern "C" int witch_flank_warp(const float *em_t, const float *tr_t,
                                const float *d1_t, const int32_t *codes,
                                const int32_t *qlens, const int32_t *slots,
                                float *fwd, float *ppB, float *ppE, float *mocc,
                                float *fspec, int H, int n_groups, int K,
                                int Lstride, int W, int G, int npl, int Mpad,
                                void *stream) {
    if (H <= 0 || n_groups <= 0) return 0;
    if (Mpad != 32 * G * npl) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define FL_ARGS em_t, tr_t, d1_t, codes, qlens, slots, fwd, ppB, ppE, mocc, \
                fspec, H, n_groups, K, Lstride, W, G, Mpad, st
    switch (npl) {
    case 8: return launch_warp<8>(FL_ARGS);
    case 16: return launch_warp<16>(FL_ARGS);
    case 24: return launch_warp<24>(FL_ARGS);
    case 32: return launch_warp<32>(FL_ARGS);
    case 40: return launch_warp<40>(FL_ARGS);
    case 48: return launch_warp<48>(FL_ARGS);
    default: return (int)cudaErrorInvalidValue;
    }
#undef FL_ARGS
}

// ---------------------------------------------------------------------
// The first version (wide models).

__global__ void flank_kernel(const float *__restrict__ em,
                             const float *__restrict__ trans,
                             const int32_t *__restrict__ codes,
                             const int32_t *__restrict__ qlens,
                             float *__restrict__ fwd_out,
                             float *__restrict__ ppB,
                             float *__restrict__ ppE,
                             float *__restrict__ mocc,
                             float *__restrict__ fspec, int H, int Mp,
                             int K, int Lstride, int W) {
    extern __shared__ float smem[];
    __shared__ Aff shA[NWARP];
    __shared__ float shR[2 * NWARP];
    const int p = blockIdx.x;            // = q * H + h
    const int h = p % H;
    const int q = p / H;
    float *sM = smem, *sI = smem + Mp, *sD = smem + 2 * Mp;
    const float *tr = trans + (size_t)h * 8 * Mp;
    const float *emh = em + (size_t)h * K * Mp;
    const float *bm = tr + T_BM * Mp;
    const int L = qlens[q];
    const int32_t *cq = codes + (size_t)q * Lstride;
    float *oB = ppB + (size_t)p * W, *oE = ppE + (size_t)p * W,
          *oO = mocc + (size_t)p * W;
    float *FS = fspec + (size_t)p * W * 5;   // log N B J C E per row

    for (int i = L + 1 + threadIdx.x; i < W; i += NT) {
        oB[i] = 0.f;
        oE[i] = 0.f;
        oO[i] = 0.f;
    }
    int k0, k1;
    chunk_of(Mp, k0, k1);
    for (int k = k0; k < k1; ++k) {
        sM[k] = 0.f;
        sI[k] = 0.f;
        sD[k] = 0.f;
    }
    const float pmove = 3.0f / ((float)L + 3.0f);
    const float ploop = 1.0f - pmove;

    // ---------------- Forward, log specials stored -------------------
    if (threadIdx.x == 0) {
        FS[0] = 0.f;               // log 1
        FS[1] = logf(pmove);
        FS[2] = -INFINITY;
        FS[3] = -INFINITY;
        FS[4] = -INFINITY;
    }
    float N = 1.f, B = pmove, J = 0.f, C = 0.f, logs = 0.f;
    for (int i = 1; i <= L; ++i) {
        __syncthreads();
        const float *e = emh + (size_t)cq[i - 1] * Mp;
        float s, mx;
        forward_core_row(sM, sI, sD, tr, e, B, Mp, s, mx, shA);
        block_sum_max(s, mx, shR);
        const float E = s;
        const float Jn = J * ploop + E * 0.5f;
        const float Cn = C * ploop + E * 0.5f;
        const float Nn = N * ploop;
        const float Bn = Nn * pmove + Jn * pmove;
        if (threadIdx.x == 0) {
            float *f = FS + (size_t)i * 5;
            f[0] = logf(Nn) + logs;
            f[1] = logf(Bn) + logs;
            f[2] = logf(Jn) + logs;
            f[3] = logf(Cn) + logs;
            f[4] = logf(E) + logs;
        }
        const float scale = fmaxf(fmaxf(mx, fmaxf(Cn, Nn)), FLANK_FLOOR);
        const float inv = 1.0f / scale;
        scale_rows(sM, sI, sD, inv, Mp);
        N = Nn * inv;
        B = Bn * inv;
        J = Jn * inv;
        C = Cn * inv;
        logs = logs + logf(scale);
    }
    const float fwd = logf(C * pmove) + logs;
    if (threadIdx.x == 0) fwd_out[p] = fwd;
    const float log_loop = logf(ploop);

    // combine row i's Backward log specials with the stored Forward ones
    // (thread 0 wrote FS, thread 0 reads it)
    auto combine = [&](int i, float lbN, float lbJ, float lbC, float lbB,
                       float lbE) {
        if (threadIdx.x != 0) return;
        const float *f = FS + (size_t)i * 5;
        oB[i] = nan0(expf(f[1] + lbB - fwd));
        oE[i] = nan0(expf(f[4] + lbE - fwd));
        if (i >= 1) {
            const float *g = f - 5;
            const float pN = expf(g[0] + log_loop + lbN - fwd);
            const float pJ = expf(g[2] + log_loop + lbJ - fwd);
            const float pC = expf(g[3] + log_loop + lbC - fwd);
            oO[i] = 1.0f - (nan0(pN) + nan0(pJ) + nan0(pC));
        } else {
            oO[i] = 0.f;
        }
    };

    // ---------------- Backward, rows combined -------------------------
    __syncthreads();
    const float EL = pmove * 0.5f;
    float *bM = sM, *bI = sI;
    backward_terminal_row(bM, bI, sD, tr, EL, Mp, shA);
    if (k0 == 0 && k1 > 0) bM[0] = 0.f;     // MnL.at[0].set(0)
    // row L: N = J = B = -inf, C = move, E = move * e_move
    combine(L, -INFINITY, -INFINITY, logf(pmove), -INFINITY,
            logf(pmove) + logf(0.5f));
    float bN = 0.f, bJ = 0.f, bC = pmove, blogs = 0.f;
    for (int i = L - 1; i >= 0; --i) {
        __syncthreads();
        const float *e = emh + (size_t)cq[i] * Mp;   // residue i+1
        float pb = 0.f;
        for (int k = k0; k < k1; ++k) pb += bm[k] * (bM[k] * e[k]);
        pb = block_reduce(pb, OpSum(), shR);
        const float Ni = bN * ploop + pb * pmove;
        const float Ji = bJ * ploop + pb * pmove;
        const float Ci = bC * ploop;
        const float Ei = Ci * 0.5f + Ji * 0.5f;
        float unused, mx;
        backward_core_row(bM, bI, sD, tr, e, Ei, Mp, unused, mx, shA);
        mx = block_reduce(mx, OpMax(), shR);
        combine(i, logf(Ni) + blogs, logf(Ji) + blogs, logf(Ci) + blogs,
                logf(pb) + blogs, logf(Ei) + blogs);
        const float scale = fmaxf(fmaxf(mx, fmaxf(Ni, Ci)), FLANK_FLOOR);
        const float inv = 1.0f / scale;
        scale_rows(bM, bI, nullptr, inv, Mp);
        bN = Ni * inv;
        bJ = Ji * inv;
        bC = Ci * inv;
        blogs = blogs + logf(scale);
    }
}

extern "C" int witch_flank(const float *em, const float *trans,
                           const int32_t *codes, const int32_t *qlens,
                           float *fwd, float *ppB, float *ppE, float *mocc,
                           float *fspec, int H, int Q, int Mp, int K,
                           int Lstride, int W, void *stream) {
    const size_t smem = (size_t)3 * Mp * sizeof(float);
    cudaError_t err = set_smem((const void *)flank_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (H <= 0 || Q <= 0) return 0;
    flank_kernel<<<(unsigned)((size_t)H * Q), NT, smem,
                   (cudaStream_t)stream>>>(em, trans, codes, qlens, fwd, ppB,
                                           ppE, mocc, fspec, H, Mp, K, Lstride,
                                           W);
    return (int)cudaGetLastError();
}
