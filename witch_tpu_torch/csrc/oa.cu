// Fused unihit posterior decoding + optimal-accuracy (OA) alignment +
// traceback per (model, query) pair, by one kernel design for Hopper in
// two instances chosen by the bank width alone (ops/oa.py:oa_layout):
// warp-per-pair (oa_warp_kernel<NPL, false>, layout 0, Mp up to 4,096)
// and over a thread-block cluster (oa_warp_kernel<NPL, true>, layout 1,
// wider models up to the 16,384-state cap). The first version, one CTA
// per pair (oa_kernel), is kept for timing (first_version=True); no path
// takes it.
//
// Replaces: witch_tpu/ops/pallas_oa.py:_oa_kernel (the TPU kernel
// reached from oa_columns_device).
//
// All compute, per pair, what the plain version (ops/oa.py:oa_ref)
// computes:
//   pass A  Backward from the terminal row L down to row 0 with exact
//           power-of-two rescaling; rows 1..L (bM, bI and the bN, bC,
//           exponent specials) go to a device scratch buffer; row 0
//           gives the total score Z.
//   pass B  Forward with power-of-two rescaling; per row the posteriors
//           ppM/ppI/ppN/ppC (f32, as on the TPU) feed the OA DP
//           (witch_tpu/hmm/align_ref.py:oa_fill semantics), accumulated
//           in native f64; traceback pointers (pm 2 bits, pi 1 bit, pd 1
//           bit) go to a byte plane in device memory, per-row E and C
//           decisions to two small arrays.
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
// What bounds it on an H100: per DP cell (model state x query row) the
// Forward and Backward take ~40 f32 operations, the posteriors 4, the OA
// DP 14 f64 operations (34 TFLOP/s against 67 for f32); and the stored
// Backward rows: 17 B per state-row (bM and bI written and read back
// once, the pointer byte written). The rows of the pairs in flight fit
// the 50 MB L2 only for short pairs, so at dna1k's widths (Mp 1,440,
// ~500 rows) those bytes go to HBM at 3.35 TB/s. The first version sat
// far above both: one CTA of 256 threads per pair crossed a dozen CTA
// barriers per row, so its time was barrier latency per row.
//
// First version (oa_kernel): f32 odds rows and f64 OA rows (36 * Mp
// bytes, ~100 KB at Mp = 2816) updated in place as in forward.cu, in
// shared memory up to Mp ~6,400; for wider models (up to the 16,384-state
// cap) the wrapper passes `rows_g` and each CTA keeps them in its own
// slice of that device buffer (L1/L2-cached). The layout is a template
// parameter, so the shared-memory instance addresses its rows as shared
// memory (a pointer chosen at run time would make every row access a
// generic one); f64 OA accumulators instead of the TPU's double-float
// pairs. Scratch is sized by the longest query for every pair.
//
// Warp-per-pair kernel (oa_warp_kernel), the design of null2.cu:
// - A pair's row of Mpad = 32 G npl states lives in registers, npl
//   consecutive states per lane, G warps per pair (G <= 8): f32 Forward M,
//   I and outflow U, and f64 OA oM, oI, oD. A CTA holds 8 / G pairs of one
//   model, whose transitions it copies into shared memory once (as float4s
//   of a lane's states, consecutive lanes on consecutive float4s) and
//   re-reads every row (fresh_zero). Emissions and the stored rows are in
//   k order, so a lane reads or writes its states as npl / 4 float4s and a
//   warp 1 KB at a time: vector accesses at fixed offsets, where a
//   per-state stride spent more instructions on addresses than on the DP.
// - Pass A is null2's Backward, pipelined one row behind its rescale
//   (exact here: the scale is a power of two), storing each scaled row and
//   its bN, bC and exponent ledger beside it; one meeting a row.
// - Pass B is null2's Forward (one meeting a row carries the delete
//   chain, the E sum, the max and the outflow across warps), then from
//   the stored row, loaded before the meeting, the posteriors and the OA
//   M and I cells: oX[k-1] of the previous row comes from the lane's
//   previous slot, the lane below (a shuffle) or the warp below (its
//   last state, carried by the same meeting). D is a prefix max: within
//   the lane, a warp scan, and across warps a second meeting. The E
//   argmax (first index, tie count, second best, M at the argmax) is a
//   warp reduction taken in the next row, beside its Forward (the row's
//   oM and oD are still in the registers there); across warps it rides
//   on that row's first meeting, since only oC, the margin and the row's
//   E/C decisions take it. So the warps of a pair meet at most twice a row, at a named
//   barrier of their own threads, never the whole CTA.
// - Pointers: a lane's npl bytes (its consecutive states) go out as one
//   word, so the plane is row-major in k ([row][Mpad], ptr_at). The
//   traceback is a second kernel, one thread per pair (oa_trace_kernel):
//   inside the fill, one lane walking dependent loads held its CTA.
// - Scratch: each pair's rows at its own offset, sized by its own length;
//   the wrapper cuts the launches by the scratch they need
//   (ops/plan.py:plan_launches), pairs of one model per CTA, longest
//   first.
//
// Cluster instance (layout 1, above Mp 4,096): one pair of G = 8 C warps
// on a cluster of C CTAs of 8 warps (C <= 8, the portable limit; 8 states
// a lane up to Mp 16,384, as the 16-state instance spills, 16 above: C 5
// at Mp 16,416). Each CTA holds its 256 lanes' slice of the transitions
// (ops/oa.py:oa_tables with C slices, 8 x 256 npl floats) in its shared
// memory, so no CTA needs the whole model; emissions and the stored rows
// stay in k order and per pair, and the traceback kernel is the same.
// The row's meetings (one in pass A, two in pass B) go through
// distributed shared memory: each warp pushes its record (the chain's
// affine carry, the sums, the max, the E argmax fields) into the same
// slot of every CTA's shared memory (lane r < C stores rank r's copy,
// cluster.cuh:put_all), then the whole cluster crosses one barrier
// (barrier.cluster arrive with release, wait with acquire) in place of
// the named pair barrier, and every CTA reads all G records from its own
// shared memory in the same fixed order, so the E argmax merge (first
// index, tie count, second best) breaks ties as align_ref.oa_trace does
// in every CTA alike. Pass A's records are double-buffered; pass B's two
// meetings alternate between two buffers, so one barrier serves each
// meeting. The loop-invariant multipliers go out once the same way, with
// each warp's last-state t_mm and t_im, which the warp above reads and
// another CTA may hold. The specials stored in pass A are read by every
// CTA, so pass A ends with a device-scope fence before the cluster
// barrier. A meeting costs ~0.4-0.5 us alone and 1-2 us with the
// exchange at these sizes (phase 2h of chip_smoke.py, ops/cluster.py),
// so a DP row costs a few us; the first version's one CTA a pair crossed
// a dozen block barriers a row over 256-thread chunk loops, with its
// scratch sized by the longest query and launches of 8 pairs.

#include <float.h>
#include <math.h>

#include "cluster.cuh"
#include "common.cuh"

static constexpr double NEGD = -(double)FLT_MAX;
static constexpr float LN2F = 0.693147182464599609375f;   // f32(ln 2)

// The total score Z (nats) and a row's posterior scale exp(e ln 2 - Z)
// from the exponent ledgers, rounded as the plain version rounds them
// (the product, then the sum; no fused multiply-add). The ledgers reach
// thousands over thousands of rows, where half an ulp of the product is
// ~1e-4: a contracted e ln 2 - Z then moved every posterior of a row by
// a relative ~1e-4 against plain, and the margins of 3,000-row pairs by
// more than 1e-4 (chip_smoke.py phase 4wo).
static __device__ __forceinline__ float ledger_z(float bN, float bled) {
    return __fadd_rn(logf(fmaxf(bN, SCALE_FLOOR)), __fmul_rn(bled, LN2F));
}

static __device__ __forceinline__ float ledger_scale(float e, float Zlog) {
    return expf(__fsub_rn(__fmul_rn(e, LN2F), Zlog));
}
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
    const float Zlog = ledger_z(bN, bled);
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
        const float sc = ledger_scale(fled + bled_i, Zlog);
        const float scN = ledger_scale(fled0 + bled_i, Zlog);
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

// ======================= warp-per-pair kernel =========================

#define OA_THREADS 256
#define OA_XS 8        // floats per warp in a Backward or Forward meeting
#define OA_XD 8        // doubles per warp in the OA part of a meeting
#define OA_WS 8        // loop-invariant floats per warp
#define OA_WS_C 12     // the same in the cluster instance (with the last
                       // state's t_mm and t_im, which another CTA may hold)

// Byte of the pointer plane for (row, state k): a lane's npl consecutive
// states go out as one word, so the plane is row-major in k. Mirrored by
// ops/oa.py:ptr_at, which the plain traceback uses.
static __device__ __forceinline__ size_t ptr_at(int row, int k, int Mpad) {
    return (size_t)row * Mpad + k;
}

// The E-state argmax of a row so far: best value r and its first state k,
// the count n of states at r, the best value s2 below r (NEGD if none),
// and M at k. Merging is associative and commutative, so any order of
// warps gives the plain version's result.
struct EBest {
    double r, s2, mxk;
    int k, n;
};

static __device__ __forceinline__ void ebest_merge(EBest &a, double r, int k, int n,
                                                   double s2, double mxk) {
    if (r > a.r) {
        a.s2 = fmax(fmax(a.s2, a.r), s2);
        a.r = r;
        a.k = k;
        a.n = n;
        a.mxk = mxk;
    } else if (r == a.r) {
        a.s2 = fmax(a.s2, s2);
        a.n += n;
        if (k < a.k) {
            a.k = k;
            a.mxk = mxk;
        }
    } else {
        a.s2 = fmax(a.s2, r);
    }
}

// A warp's E argmax from its lanes' states (cE = max(M, D) on 1..Mm),
// without branches: the warp's best value first, then against it the
// count, the best value below and the first state (and M there).
template <int NPL>
static __device__ __forceinline__ EBest warp_ebest(const double (&oM)[NPL],
                                                   const double (&oD)[NPL],
                                                   int kb, int Mm, double rl) {
    const int lane = threadIdx.x & 31;
    double r = rl;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r = fmax(r, __shfl_xor_sync(FULL_MASK, r, o));
    int n = 0, k = 0x7fffffff;
    double s2 = NEGD, mk = NEGD;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
        const int kk = kb + j;
        const bool km = kk >= 1 && kk <= Mm;
        const double cE = km ? fmax(oM[j], oD[j]) : NEGD;
        const bool at = km && cE == r;
        const bool first = at && k == 0x7fffffff;
        n += at ? 1 : 0;
        s2 = fmax(s2, (km && cE < r) ? cE : NEGD);
        k = first ? kk : k;
        mk = first ? oM[j] : mk;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        n += __shfl_xor_sync(FULL_MASK, n, o);
        s2 = fmax(s2, __shfl_xor_sync(FULL_MASK, s2, o));
        k = min(k, __shfl_xor_sync(FULL_MASK, k, o));
    }
    // M at the first argmax, from the lane that holds it
    mk = __shfl_sync(FULL_MASK, mk, k == 0x7fffffff ? lane : (k / NPL) & 31);
    return EBest{r, s2, mk, k, n};
}

static __device__ __forceinline__ float comp(const float4 &v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

static __device__ __forceinline__ void setc(float4 &v, int c, float x) {
    if (c == 0) v.x = x;
    else if (c == 1) v.y = x;
    else if (c == 2) v.z = x;
    else v.w = x;
}

// A lane's NPL consecutive states from NPL / 4 float4s `stride` apart:
// 1 for a k-order row, the pair's lanes for the transitions in shared
// memory.
template <int NPL>
static __device__ __forceinline__ void ld_row(float (&d)[NPL], const float4 *p,
                                              int stride = 1) {
#pragma unroll
    for (int hh = 0; hh < NPL / 4; ++hh) {
        const float4 q = p[hh * stride];
        d[4 * hh] = q.x;
        d[4 * hh + 1] = q.y;
        d[4 * hh + 2] = q.z;
        d[4 * hh + 3] = q.w;
    }
}

template <int NPL, bool kC>
__global__ void __launch_bounds__(OA_THREADS)
    oa_warp_kernel(const float *__restrict__ em_t, const float *__restrict__ tr_t,
                   const int32_t *__restrict__ model_of,
                   const int32_t *__restrict__ ms,
                   const int32_t *__restrict__ codes,
                   const int64_t *__restrict__ code_off,
                   const int32_t *__restrict__ lens,
                   const float *__restrict__ pmoves,
                   const int32_t *__restrict__ cta_pair,
                   const int64_t *__restrict__ roff, float *__restrict__ brows,
                   float *__restrict__ bspec, uint8_t *__restrict__ ptr,
                   int32_t *__restrict__ rowk, uint8_t *__restrict__ rowf,
                   float *__restrict__ stat, int K, int G, int Mpad, int nC) {
    extern __shared__ float smem[];
    constexpr int WS = kC ? OA_WS_C : OA_WS;
    const int S = G * 32;                  // lanes of a pair
    const int WP = kC ? 1 : blockDim.x / S;   // pairs in this CTA (cluster)
    const int WG = WP * G;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rank = kC ? cluster_rank() : 0;
    const int p = kC ? 0 : warp / G;
    const int g = kC ? rank * (OA_THREADS / 32) + warp : warp - p * G;
    const int cta = kC ? blockIdx.x / nC : blockIdx.x;   // the plan's CTA
    const int pr = cta_pair[(size_t)cta * WP + p];
    // the plan fills a CTA's first slot and gives all its slots one model
    const int h = model_of[cta_pair[(size_t)cta * WP]];
    // transitions of the lanes this CTA holds: all the pair's, or in the
    // cluster instance its own 256 lanes' (oa_tables with C slices)
    const int SB = kC ? OA_THREADS : S;
    const int MT = kC ? Mpad / nC : Mpad;
    float *sXB = smem + 8 * MT;            // pass A: [2][WP][G][OA_XS]
    float *sW = sXB + 2 * WG * OA_XS;      // [WP][G][WS]
    float *sXF = sW + WG * WS;             // pass B meeting 1: [WP][G][OA_XS]
    double *sD1 = (double *)(sXF + WG * OA_XS);   // [WP][G][OA_XD]
    double *sD2 = sD1 + WG * OA_XD;               // meeting 2: [WP][G][4]
    {
        const float4 *src = reinterpret_cast<const float4 *>(
            tr_t + (size_t)h * 8 * Mpad + (size_t)rank * 8 * MT);
        float4 *dst = reinterpret_cast<float4 *>(smem);
        for (int t = threadIdx.x; t < 2 * MT; t += blockDim.x) dst[t] = src[t];
        __syncthreads();                    // once per CTA, not per row
        if constexpr (kC) cluster_meet();   // every CTA started: DSMEM is live
    }
    if (pr < 0) return;                     // the pair's warps leave together
    const int Mm = ms[pr];
    const int L = lens[pr];
    const int32_t *cs = codes + code_off[pr];
    const float pmove = pmoves[pr];
    const float ploop = 1.0f - pmove;
    const int slot0 = g * 32 + lane;
    const int kb = slot0 * NPL;            // the lane's first state
    const int MQ = Mpad / 4;               // float4s in a row
    // transitions in shared memory: float4 (r * NPL/4 + hh) * S + slot holds
    // states slot * NPL + 4 hh + (0..3); emissions and the stored rows in
    // k order, a lane's states NPL / 4 consecutive float4s
    const float4 *T4 = reinterpret_cast<const float4 *>(smem) + (kC ? warp * 32 + lane : slot0);
    const float4 *em4 = reinterpret_cast<const float4 *>(em_t) + (size_t)h * K * MQ + (kb >> 2);
    const int64_t r0 = roff[pr];
    float4 *BR4 = reinterpret_cast<float4 *>(brows) + (size_t)r0 * 2 * MQ + (kb >> 2);
    float *BS = bspec + (size_t)r0 * 3;
    uint8_t *PT = ptr + (size_t)r0 * Mpad;
    int32_t *RK = rowk + r0;
    uint8_t *RF = rowf + r0;
    float *sWp = sW + p * G * WS;
    const int bar = 1 + p, nbar = S;
#define Q(r, hh) T4[((r) * (NPL / 4) + (hh)) * SB + zr]
#define TLAST(r, sl) smem[(((r) * (NPL / 4) + NPL / 4 - 1) * S + (sl)) * 4 + 3]
#define XBUF(ph) (sXB + (((ph) & 1) * WP + p) * G * OA_XS)
    int zr = 0;                            // see fresh_zero
    int ph = 0;                            // pass A meetings so far (parity)

    // ---- invariants of the delete chains (null2.cu) ----
    // Forward: within the lane D at its j-th state is Dloc_j + P_j c, c the
    // chain value entering the lane, P_j = prod_{t < j} t_dd.
    float tdd0[NPL], tdm0[NPL];
    ld_row<NPL>(tdd0, T4 + T_DD * (NPL / 4) * SB, SB);
    ld_row<NPL>(tdm0, T4 + T_DM * (NPL / 4) * SB, SB);
    float Pj = 1.f, SP = 0.f, Plast = 1.f;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
        SP += Pj;
        Plast = Pj;
        Pj *= tdd0[j];
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
    // Backward, right to left: D[k] = c[k] + t_dd[k] D[k+1], c[k] =
    // mne[k+1] t_dm[k] + bE; the warp's last lane takes
    // Z = mne[s1] t_dm[k1] + t_dd[k1] D[s1] (k1 its last state, s1 the next
    // warp's first) in place of the D entering from its right.
    float ab = 1.f, bc = 0.f;
#pragma unroll
    for (int j = NPL - 1; j >= 0; --j) {
        const float t = (lane == 31 && j == NPL - 1) ? 1.f : tdd0[j];
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
    const float SBc = __shfl_down_sync(FULL_MASK, bci, 1);
    const float SA = __shfl_down_sync(FULL_MASK, xb, 1);
    if (G > 1) {
        float se = ea * SP;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(FULL_MASK, se, o);
        const float aw = __shfl_sync(FULL_MASK, xa, 31);
        const float dl1 = __shfl_sync(FULL_MASK, ea * Plast, 31);
        float *w = sWp + g * WS;
        if constexpr (kC) {
            // into every CTA of the cluster, with the last state's t_mm and
            // t_im (meeting 1 of pass B reads the warp below's)
            put_all_uniform(w + 0, aw, nC);
            put_all_uniform(w + 1, se, nC);
            put_all_uniform(w + 2, dl1, nC);
            put_all(w + 3, xb, 0, nC);
            put_all(w + 4, bci, 0, nC);
            put_all(w + 5, tdm0[NPL - 1], 31, nC);
            put_all(w + 6, tdd0[NPL - 1], 31, nC);
            put_all(w + 7, comp(Q(T_MM, NPL / 4 - 1), 3), 31, nC);
            put_all(w + 8, comp(Q(T_IM, NPL / 4 - 1), 3), 31, nC);
            cluster_meet();
        } else {
            if (lane == 0) {
                w[0] = aw;                   // the warp's Forward multiplier
                w[1] = se;
                w[2] = dl1;
                w[3] = xb;                   // Z multiplier of D at the first state
                w[4] = bci;                  // its bE part
            }
            if (lane == 31) {
                w[5] = tdm0[NPL - 1];
                w[6] = tdd0[NPL - 1];
            }
            pair_barrier(bar, nbar);
        }
    }

    // ---- pass A: Backward, one row behind its scale, rows 1..L stored ----
    LaneRow<NPL> row;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
        row.M(j) = 0.f;                      // the pending row (unscaled)
        row.I(j) = 0.f;
    }
    float bNu = 0.f, bCu = 0.f;              // the pending row's N and C
    float bN = 0.f, bC = 0.f, bled = 0.f;    // scaled, and the exponent ledger
    float mxp = 0.f;                         // the pending row's lane max
    int cw = 0;                              // codes of 32 rows, one per lane
    for (int i = L; i >= -1; --i) {
        const int zr = fresh_zero();
        // row i from the pending row i+1 (none yet when i == L, the
        // terminal row; no new row when i == -1, where row 0 is scaled)
        const bool fresh = (i == L), newrow = (i >= 0);
        if (newrow && !fresh && (i == L - 1 || (i & 31) == 31))
            cw = cs[min((i & ~31) + lane, L - 1)];
        const int x = __shfl_sync(FULL_MASK, cw, i & 31);
        float ev[NPL];                       // emissions of residue i
        ld_row<NPL>(ev, em4 + (size_t)((newrow && !fresh) ? x : 0) * MQ);
        float Bv = 0.f, bl = 0.f, m0 = 0.f, mr = 0.f;
        if (newrow && !fresh) {
            // mne of the pending row (unscaled), its B sum and the chain's
            // mne part with nothing entering from the right
            m0 = row.M(0) * ev[0];
            mr = __shfl_down_sync(FULL_MASK, m0, 1);
            if (lane == 31) mr = 0.f;
            float mnu = mr;
#pragma unroll
            for (int hh = NPL / 4 - 1; hh >= 0; --hh) {
                const float4 qbm = Q(T_BM, hh), qdm = Q(T_DM, hh), qdd = Q(T_DD, hh);
#pragma unroll
                for (int c = 3; c >= 0; --c) {
                    const int j = 4 * hh + c;
                    const float mj = row.M(j) * ev[j];
                    Bv += comp(qbm, c) * mj;
                    bl = mnu * comp(qdm, c) + comp(qdd, c) * bl;
                    mnu = mj;
                }
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
            float *xx = xr + g * OA_XS;
            if constexpr (kC) {
                put_all_uniform(xx + 0, mxa, nC);
                put_all_uniform(xx + 1, Bva, nC);
                put_all(xx + 2, bi, 0, nC);
                put_all(xx + 3, m0, 0, nC);
                cluster_meet();              // the one meeting of the row
            } else {
                if (lane == 0) {
                    xx[0] = mxa;
                    xx[1] = Bva;
                    xx[2] = bi;              // the warp's chain, mne part
                    xx[3] = m0;              // mne at the warp's first state
                }
                pair_barrier(bar, nbar);     // the one meeting of the row
            }
            mxa = 0.f;
            Bva = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                mxa = fmaxf(mxa, xr[gg * OA_XS]);
                Bva += xr[gg * OA_XS + 1];
            }
        }
        // the pending row's scale (1 for the terminal row), a power of two
        float iv = 1.f;
        if (!fresh) {
            const bool term = (i + 1 == L);
            const float scale =
                term ? 1.f : fmaxf(mxa, fmaxf(bNu, fmaxf(bCu, SCALE_FLOOR)));
            float kexp;
            po2_scale(scale, iv, kexp);
            bN = bNu * iv;
            bC = bCu * iv;
            bled = term ? 0.f : bled + kexp;
        }
        const bool store = !fresh && i >= 0;  // the pending row is row i+1 >= 1
        if (store && g == 0 && lane == 0) {
            BS[(size_t)i * 3 + 0] = bN;
            BS[(size_t)i * 3 + 1] = bC;
            BS[(size_t)i * 3 + 2] = bled;
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
                const float *w = sWp + gg * WS;
                Zg = mn1 * w[5] + w[6] * Dn1;
                if (gg == g) break;
                const float *xg = xr + gg * OA_XS;
                Dn1 = iv * xg[2] + bEn * w[4] + w[3] * Zg;
                mn1 = iv * xg[3];
            }
        }
        float Dn = lane < 31 ? iv * ebm + bEn * SBc + SA * Zg : Dn1;
        float mnext = lane < 31 ? iv * mr : mn1;
        // scale and store the pending row, and compute row i from it
        float4 *Rs = BR4 + (size_t)(store ? i : 0) * 2 * MQ;
        float mxn = 0.f;
#pragma unroll
        for (int hh = NPL / 4 - 1; hh >= 0; --hh) {
            const float4 qmm = Q(T_MM, hh), qmi = Q(T_MI, hh), qmd = Q(T_MD, hh),
                         qim = Q(T_IM, hh), qii = Q(T_II, hh), qdm = Q(T_DM, hh),
                         qdd = Q(T_DD, hh);
            float4 sm, si;                   // the scaled pending row
#pragma unroll
            for (int c = 3; c >= 0; --c) {
                const int j = 4 * hh + c;
                const float bms = row.M(j) * iv, bis = row.I(j) * iv;
                setc(sm, c, bms);
                setc(si, c, bis);
                if (newrow) {
                    const float mj = bms * ev[j];
                    const float Mi = bEn + mnext * comp(qmm, c) + bis * comp(qmi, c) +
                                     Dn * comp(qmd, c);
                    const float Ii = mnext * comp(qim, c) + bis * comp(qii, c);
                    Dn = (mnext * comp(qdm, c) + bEn) + comp(qdd, c) * Dn;
                    mnext = mj;
                    row.M(j) = Mi;
                    row.I(j) = Ii;
                    mxn = fmaxf(mxn, Mi);
                }
            }
            if (store) {
                Rs[hh] = sm;
                Rs[MQ + hh] = si;
            }
        }
        mxp = mxn;
        bNu = bNn;
        bCu = bCn;
    }
    const float Zlog = ledger_z(bN, bled);
    // the specials of every row visible to the pair's warps
    if constexpr (kC) {
        __threadfence();                     // other CTAs' SMs read them
        cluster_meet();
    } else {
        __threadfence_block();
        if (G > 1) pair_barrier(bar, nbar);
        else __syncwarp();
    }

    // ---- pass B: Forward, posteriors and the OA fill ----
    double oM[NPL], oI[NPL], oD[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
        row.M(j) = 0.f;                      // this row, unscaled
        row.I(j) = 0.f;
        row.U(j) = 0.f;                      // outflow of the previous row
        oM[j] = NEGD;
        oI[j] = NEGD;
        oD[j] = NEGD;
    }
    float N = 1.f, B = pmove, C = 0.f, inv = 1.f, fled = 0.f;
    float uin = 0.f;        // outflow of the state left of the lane's chunk
    double oN = 0.0, oC = NEGD, mm = INFINITY;
    double rl_prev = NEGD;   // row i-1's best E candidate in the lane
    float ppC_prev = 0.f;
    float *xf = sXF + p * G * OA_XS;
    double *xd1 = sD1 + p * G * OA_XD;
    double *xd2 = sD2 + p * G * 4;
    // finish row `ri` (1-based) from its E argmax: oC, the margin and the
    // row's decisions, identically in every warp of the pair
#define FINISH_ROW(ri, eb, ppCr)                                                  \
    do {                                                                          \
        const double rr = (eb).r, mk = (eb).mxk;                                  \
        const double mE = ((eb).n > 1 || (eb).s2 == NEGD) ? INFINITY : rr - (eb).s2; \
        const bool eIsD = rr > mk;                                                \
        const double mED = (mk == rr) ? INFINITY : rr - mk;                       \
        const double cl = oC + (double)(ppCr);                                    \
        const bool cge = cl >= rr;                                                \
        const double mC = (cl == rr) ? INFINITY : fabs(cl - rr);                  \
        oC = cge ? cl : rr;                                                       \
        mm = fmin(mm, fmin(mE, fmin(mC, mED)));                                   \
        if (g == 0 && lane == 0) {                                                \
            RK[(ri) - 1] = (eb).k;                                                \
            RF[(ri) - 1] = (uint8_t)((eIsD ? 1 : 0) + (cge ? 2 : 0));             \
        }                                                                         \
    } while (0)
#define XD_EBEST(v, eb)                                                           \
    do {                                                                          \
        (v)[3] = (eb).r;                                                          \
        (v)[4] = (eb).s2;                                                         \
        (v)[5] = (eb).mxk;                                                        \
        (v)[6] = (double)(eb).k;                                                  \
        (v)[7] = (double)(eb).n;                                                  \
    } while (0)
#define XD_MERGE(eb)                                                              \
    do {                                                                          \
        (eb) = EBest{NEGD, NEGD, NEGD, 0x7fffffff, 0};                            \
        for (int gg = 0; gg < G; ++gg) {                                          \
            const double *v = xd1 + gg * OA_XD;                                   \
            ebest_merge((eb), v[3], (int)v[6], (int)v[7], v[4], v[5]);            \
        }                                                                         \
    } while (0)

    for (int i = 1; i <= L; ++i) {
        const int zr = fresh_zero();
        const int r = i - 1;                 // residue, stored row and pointer row
        if ((r & 31) == 0) cw = cs[min(r + lane, L - 1)];
        float ev[NPL];                       // emissions of residue i
        ld_row<NPL>(ev, em4 + (size_t)__shfl_sync(FULL_MASK, cw, r & 31) * MQ);
        // the stored Backward row i, loaded ahead of the meeting
        float rbM[NPL], rbI[NPL];
        ld_row<NPL>(rbM, BR4 + (size_t)r * 2 * MQ);
        ld_row<NPL>(rbI, BR4 + (size_t)r * 2 * MQ + MQ);
        // row i-1's E argmax over this warp, from oM and oD before this
        // row overwrites them: its shuffles overlap the Forward below
        const EBest ebp = warp_ebest<NPL>(oM, oD, kb, Mm, rl_prev);
        const float bN_i = BS[(size_t)r * 3 + 0], bC_i = BS[(size_t)r * 3 + 1],
                    bled_i = BS[(size_t)r * 3 + 2];
        // Forward, pass 1: M and I of row i with zero entering the lane's
        // delete chain
        float b = 0.f, sM = 0.f, sD = 0.f, mx = 0.f, blast = 0.f, up = uin;
#pragma unroll
        for (int hh = 0; hh < NPL / 4; ++hh) {
            const float4 qbm = Q(T_BM, hh), qmi = Q(T_MI, hh), qii = Q(T_II, hh),
                         qdd = Q(T_DD, hh), qmd = Q(T_MD, hh);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = 4 * hh + c;
                const float Mr = (up * inv + B * comp(qbm, c)) * ev[j];
                const float Ir =
                    (row.M(j) * comp(qmi, c) + row.I(j) * comp(qii, c)) * inv;
                up = row.U(j);
                sD += b;
                blast = b;
                b = comp(qdd, c) * b + comp(qmd, c) * Mr;
                sM += Mr;
                mx = fmaxf(mx, Mr);
                row.M(j) = Mr;
                row.I(j) = Ir;
            }
        }
        float bi = b;                        // inclusive scan of the lane maps
#pragma unroll
        for (int t = 0; t < 5; ++t) {
            const int s = 1 << t;
            const float pb = __shfl_up_sync(FULL_MASK, bi, s);
            if (lane >= s) bi = pb * Astep[t] + bi;
        }
        float ebf = __shfl_up_sync(FULL_MASK, bi, 1);
        if (lane == 0) ebf = 0.f;
        float E = sM + sD + ebf * SP;        // with zero entering the warp
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            E += __shfl_xor_sync(FULL_MASK, E, o);
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
        }
        // the previous row's oM, oI, oD at state k-1 of the lane's first
        // state: the lane below, or the warp below through the meeting
        double lM = __shfl_up_sync(FULL_MASK, oM[NPL - 1], 1);
        double lI = __shfl_up_sync(FULL_MASK, oI[NPL - 1], 1);
        double lD = __shfl_up_sync(FULL_MASK, oD[NPL - 1], 1);
        if (lane == 0) {
            lM = NEGD;
            lI = NEGD;
            lD = NEGD;
        }
        float Din = 0.f, uB = 0.f;
        if (G > 1) {
            if constexpr (kC) {
                float *xx = xf + g * OA_XS;
                put_all(xx + 0, bi, 31, nC);
                put_all_uniform(xx + 1, E, nC);
                put_all_uniform(xx + 2, mx, nC);
                put_all(xx + 3, row.M(NPL - 1), 31, nC);
                put_all(xx + 4, row.I(NPL - 1), 31, nC);
                put_all(xx + 5, blast + Plast * ebf, 31, nC);
                double *v = xd1 + g * OA_XD;
                put_all(v + 0, oM[NPL - 1], 31, nC);
                put_all(v + 1, oI[NPL - 1], 31, nC);
                put_all(v + 2, oD[NPL - 1], 31, nC);
                if (i > 1) {                 // ebp is the same in every lane
                    put_all_uniform(v + 3, ebp.r, nC);
                    put_all_uniform(v + 4, ebp.s2, nC);
                    put_all_uniform(v + 5, ebp.mxk, nC);
                    put_all_uniform(v + 6, (double)ebp.k, nC);
                    put_all_uniform(v + 7, (double)ebp.n, nC);
                }
                cluster_meet();              // meeting 1 of the row
            } else {
                if (lane == 31) {
                    float *xx = xf + g * OA_XS;
                    xx[0] = bi;
                    xx[1] = E;
                    xx[2] = mx;
                    xx[3] = row.M(NPL - 1);
                    xx[4] = row.I(NPL - 1);
                    xx[5] = blast + Plast * ebf;
                    double *v = xd1 + g * OA_XD;
                    v[0] = oM[NPL - 1];
                    v[1] = oI[NPL - 1];
                    v[2] = oD[NPL - 1];
                }
                if (lane == 0 && i > 1) XD_EBEST(xd1 + g * OA_XD, ebp);
                pair_barrier(bar, nbar);     // meeting 1 of the row
            }
            float D = 0.f, Et = 0.f, mt = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                const float *xg = xf + gg * OA_XS;
                const float *wg = sWp + gg * WS;
                if (gg == g) Din = D;
                if (gg == g - 1) {
                    const float Dl = xg[5] + wg[2] * D;
                    if constexpr (kC) {
                        uB = xg[3] * wg[7] + xg[4] * wg[8] + Dl * wg[5];
                    } else {
                        const int sl = gg * 32 + 31;
                        uB = xg[3] * TLAST(T_MM, sl) + xg[4] * TLAST(T_IM, sl) +
                             Dl * TLAST(T_DM, sl);
                    }
                }
                Et += xg[1] + D * wg[1];
                mt = fmaxf(mt, xg[2]);
                D = wg[0] * D + xg[0];
            }
            E = Et;
            mx = mt;
            if (g > 0 && lane == 0) {
                const double *v = xd1 + (g - 1) * OA_XD;
                lM = v[0];
                lI = v[1];
                lD = v[2];
            }
            if (i > 1) {                     // row i-1's E argmax, all warps
                EBest eb;
                XD_MERGE(eb);
                FINISH_ROW(i - 1, eb, ppC_prev);
            }
        } else if (i > 1) {
            FINISH_ROW(i - 1, ebp, ppC_prev);
        }
        const float Cn = C * ploop + E;      // unihit: E -> C = 1
        const float Nn = N * ploop;
        const float Bn = Nn * pmove;
        const float scale = fmaxf(mx, fmaxf(Cn, fmaxf(Nn, SCALE_FLOOR)));
        float iv, kexp;
        po2_scale(scale, iv, kexp);
        const float N0 = N, C0 = C, fled0 = fled;
        N = Nn * iv;
        B = Bn * iv;
        C = Cn * iv;
        fled = fled0 + kexp;
        const float sc = ledger_scale(fled + bled_i, Zlog);
        const float scN = ledger_scale(fled0 + bled_i, Zlog);
        const float ppN = N0 * ploop * bN_i * scN;
        const float ppC = C0 * ploop * bC_i * scN;

        // Forward pass 2 (D with its true entering value, the outflow U),
        // the posteriors and the OA M and I cells (oX[k-1] still the
        // previous row's: ascending, the old value carried in pM, pI, pD)
        float c = ebf + ea * Din;
        double pM = lM, pI = lI, pD = lD;
        double lmx = NEGD, lmx0 = NEGD;      // the lane's max of M, and without its last state
        uint32_t pw[NPL / 4];
#pragma unroll
        for (int w = 0; w < NPL / 4; ++w) pw[w] = 0u;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
            const int k = kb + j;
            const int hh = j >> 2, cc = j & 3;
            const float4 qdd = Q(T_DD, hh), qmd = Q(T_MD, hh), qmm = Q(T_MM, hh),
                         qim = Q(T_IM, hh), qdm = Q(T_DM, hh);
            const float D = c;
            c = comp(qdd, cc) * c + comp(qmd, cc) * row.M(j);
            row.U(j) = row.M(j) * comp(qmm, cc) + row.I(j) * comp(qim, cc) +
                       D * comp(qdm, cc);
            const bool km = k >= 1 && k <= Mm;
            const bool im = k >= 1 && k <= Mm - 1;
            const float ppM = km ? (row.M(j) * iv) * rbM[j] * sc : 0.f;
            const float ppI = im ? (row.I(j) * iv) * rbI[j] * sc : 0.f;
            const double ch = fmax(fmax(fmax(pM, pI), pD), oN);
            const int pm = (pM == ch) ? 0 : (pI == ch) ? 1 : (pD == ch) ? 2 : 3;
            const double oMk = oM[j], oIk = oI[j];
            const int pi = (oMk >= oIk) ? 0 : 1;
            pM = oMk;
            pI = oIk;
            pD = oD[j];
            oM[j] = km ? ch + (double)ppM : NEGD;
            oI[j] = im ? fmax(oMk, oIk) + (double)ppI : NEGD;
            pw[j >> 2] |= (uint32_t)(pm + 4 * pi) << (8 * (j & 3));
            if (j < NPL - 1) lmx0 = fmax(lmx0, oM[j]);
            lmx = fmax(lmx, oM[j]);
        }
        oN = oN + (double)ppN;
        uin = __shfl_up_sync(FULL_MASK, row.U(NPL - 1), 1);
        if (lane == 0) uin = uB;
        inv = iv;

        // D: the prefix max of this row's M over states left of k; the
        // lanes below (warp scan) and the warps below (meeting 2)
        double xs = lmx;                     // inclusive scan over lanes
#pragma unroll
        for (int t = 0; t < 5; ++t) {
            const int s = 1 << t;
            const double q = __shfl_up_sync(FULL_MASK, xs, s);
            if (lane >= s) xs = fmax(xs, q);
        }
        double run = __shfl_up_sync(FULL_MASK, xs, 1);   // lanes below
        if (lane == 0) run = NEGD;
        double enter = NEGD, pMx = NEGD, pDx = NEGD;   // M and D at k-1 of the lane's first state
        if (G > 1) {
            double *v = xd2 + g * 4;
            if constexpr (kC) {
                put_all(v + 0, xs, 31, nC);
                put_all(v + 1, fmax(run, lmx0), 31, nC);
                put_all(v + 2, oM[NPL - 1], 31, nC);
                cluster_meet();              // meeting 2 of the row
            } else {
                if (lane == 31) {
                    v[0] = xs;               // the warp's max
                    v[1] = fmax(run, lmx0);  // the same without its last state
                    v[2] = oM[NPL - 1];      // M at its last state
                }
                pair_barrier(bar, nbar);     // meeting 2 of the row
            }
            double below = NEGD;             // max over the warps below g-1
            for (int gg = 0; gg < g; ++gg) {
                const double *v = xd2 + gg * 4;
                if (gg == g - 1) {
                    pMx = v[2];
                    pDx = (kb - 1 >= 2 && kb - 1 <= Mm) ? fmax(below, v[1]) : NEGD;
                }
                below = fmax(below, v[0]);
            }
            enter = below;
        }
        run = fmax(run, enter);
        {   // D at the lane's last state, for the lane above
            const int kl = kb + NPL - 1;
            const double dl = (kl >= 2 && kl <= Mm) ? fmax(run, lmx0) : NEGD;
            const double qd = __shfl_up_sync(FULL_MASK, dl, 1);
            const double qm = __shfl_up_sync(FULL_MASK, oM[NPL - 1], 1);
            if (lane > 0) {
                pDx = qd;
                pMx = qm;
            }
        }
        double rl = NEGD;                    // the lane's best E candidate
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
            const int k = kb + j;
            const double Mx = oM[j];
            const double Dx = (k >= 2 && k <= Mm) ? run : NEGD;
            run = fmax(run, Mx);
            pw[j >> 2] |= (uint32_t)((pMx >= pDx) ? 0 : 8) << (8 * (j & 3));
            pMx = Mx;
            pDx = Dx;
            oD[j] = Dx;
            if (k >= 1 && k <= Mm) rl = fmax(rl, fmax(Mx, Dx));
        }
        uint8_t *Pr = PT + ptr_at(r, kb, Mpad);
        if constexpr (NPL == 8) {
            *reinterpret_cast<uint2 *>(Pr) = make_uint2(pw[0], pw[1]);
        } else {
#pragma unroll
            for (int w = 0; w < NPL / 4; w += 4)
                *reinterpret_cast<uint4 *>(Pr + 4 * w) =
                    make_uint4(pw[w], pw[w + 1], pw[w + 2], pw[w + 3]);
        }
        rl_prev = rl;                        // finished in the next row
        ppC_prev = ppC;
    }
    if (L > 0) {                             // the last row's E argmax
        const EBest ebp = warp_ebest<NPL>(oM, oD, kb, Mm, rl_prev);
        if (G > 1) {
            if constexpr (kC) {
                double *v = xd1 + g * OA_XD;
                put_all_uniform(v + 3, ebp.r, nC);
                put_all_uniform(v + 4, ebp.s2, nC);
                put_all_uniform(v + 5, ebp.mxk, nC);
                put_all_uniform(v + 6, (double)ebp.k, nC);
                put_all_uniform(v + 7, (double)ebp.n, nC);
                cluster_meet();
            } else {
                if (lane == 0) XD_EBEST(xd1 + g * OA_XD, ebp);
                pair_barrier(bar, nbar);
            }
            EBest eb;
            XD_MERGE(eb);
            FINISH_ROW(L, eb, ppC_prev);
        } else {
            FINISH_ROW(L, ebp, ppC_prev);
        }
    }
#undef FINISH_ROW
#undef XD_EBEST
#undef XD_MERGE
#undef Q
#undef TLAST
#undef XBUF
    if (g == 0 && lane == 0) {
        stat[(size_t)pr * 4 + 0] = (float)mm;
        stat[(size_t)pr * 4 + 2] = Zlog;
    }
    if constexpr (kC) cluster_meet();        // no CTA leaves while others write to it
}

// Pass C of the warp-per-pair kernel: the first-max-wins traceback, one
// thread per pair of the launch (its nslot CTA slots), after the fill
// kernel: one dependent load a step, so the pairs walk side by side
// instead of each holding its fill CTA.
__global__ void oa_trace_kernel(const int32_t *__restrict__ cta_pair, int nslot,
                                const int64_t *__restrict__ code_off,
                                const int32_t *__restrict__ lens,
                                const int64_t *__restrict__ roff,
                                const uint8_t *__restrict__ ptr,
                                const int32_t *__restrict__ rowk,
                                const uint8_t *__restrict__ rowf,
                                int32_t *__restrict__ cols, float *__restrict__ stat,
                                int Mp, int Mpad) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= nslot) return;
    const int pr = cta_pair[t];
    if (pr < 0) return;
    const int L = lens[pr];
    const int64_t r0 = roff[pr];
    const uint8_t *PT = ptr + (size_t)r0 * Mpad;
    const int32_t *RK = rowk + r0;
    const uint8_t *RF = rowf + r0;
    int32_t *co = cols + code_off[pr];
    int i = L, k = 0, st = 0, steps = 0, dead = (L > 0) ? 0 : 1;
    const int max_steps = 2 * L + Mp + 16;
    while (!(st == 5 && i == 0) && steps < max_steps && !dead) {
        const int rw = max(i, 1) - 1;
        const int kEr = RK[rw];
        const int fl = RF[rw];
        const int pb = PT[ptr_at(rw, k, Mpad)];
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
            if (i > 0) co[rw] = k - 1;
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
    stat[(size_t)pr * 4 + 1] = ok ? 1.f : 0.f;
    stat[(size_t)pr * 4 + 3] = (float)steps;
}

// MT: the states whose transitions a CTA holds; WS: OA_WS or OA_WS_C
static size_t warp_smem_bytes(int WG, int MT, int WS = OA_WS) {
    return (size_t)(8 * MT + 2 * WG * OA_XS + WG * WS + WG * OA_XS) * sizeof(float) +
           (size_t)(WG * OA_XD + WG * 4) * sizeof(double);
}

template <int NPL>
static int launch_warp(const float *em_t, const float *tr_t, const int32_t *model_of,
                       const int32_t *ms, const int32_t *codes, const int64_t *code_off,
                       const int32_t *lens, const float *pmoves, const int32_t *cta_pair,
                       const int64_t *roff, float *brows, float *bspec, uint8_t *ptr,
                       int32_t *rowk, uint8_t *rowf, int32_t *cols, float *stat, int ncta,
                       int K, int G, int Mp, int Mpad, cudaStream_t stream) {
    const int WP = OA_THREADS / (32 * G) > 0 ? OA_THREADS / (32 * G) : 1;
    const int threads = WP * G * 32;
    if (threads > OA_THREADS) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = warp_smem_bytes(WP * G, Mpad);
    cudaError_t err = set_smem((const void *)oa_warp_kernel<NPL, false>, smem);
    if (err != cudaSuccess) return (int)err;
    if (ncta > 0) {
        oa_warp_kernel<NPL, false><<<(unsigned)ncta, threads, smem, stream>>>(
            em_t, tr_t, model_of, ms, codes, code_off, lens, pmoves, cta_pair, roff,
            brows, bspec, ptr, rowk, rowf, stat, K, G, Mpad, 1);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const int nslot = ncta * WP;
        oa_trace_kernel<<<(unsigned)((nslot + 127) / 128), 128, 0, stream>>>(
            cta_pair, nslot, code_off, lens, roff, ptr, rowk, rowf, cols, stat, Mp,
            Mpad);
    }
    return (int)cudaGetLastError();
}

// The warp-per-pair kernel: npl in {8, 16} states per lane, G <= 8 warps
// per pair, Mpad = 32 G npl; ncta CTAs of 8 / G pairs each (cta_pair, -1
// for an empty slot). Scratch per pair at roff[pair] rows: brows [rows][2
// Mpad] f32, bspec [rows][3] f32, ptr [rows][Mpad] bytes, rowk [rows]
// int32, rowf [rows] bytes. Returns a cudaError_t code.
extern "C" int witch_oa_warp(const float *em_t, const float *tr_t,
                             const int32_t *model_of, const int32_t *ms,
                             const int32_t *codes, const int64_t *code_off,
                             const int32_t *lens, const float *pmoves,
                             const int32_t *cta_pair, const int64_t *roff,
                             float *brows, float *bspec, uint8_t *ptr,
                             int32_t *rowk, uint8_t *rowf, int32_t *cols,
                             float *stat, int ncta, int K, int G, int npl,
                             int Mp, int Mpad, void *stream) {
    if (Mpad != 32 * G * npl || Mp > Mpad || G < 1 || G > 8)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define OA_LAUNCH(NPL_)                                                               \
    launch_warp<NPL_>(em_t, tr_t, model_of, ms, codes, code_off, lens, pmoves,         \
                      cta_pair, roff, brows, bspec, ptr, rowk, rowf, cols, stat, ncta, \
                      K, G, Mp, Mpad, st)
    switch (npl) {
    case 8: return OA_LAUNCH(8);
    case 16: return OA_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
    }
#undef OA_LAUNCH
}

// The cluster instance: one pair per cluster of C CTAs of 8 warps (G = 8 C
// warps a pair), npl in {8, 16}, Mpad = 32 G npl; ncta clusters (cta_pair,
// a pair each), scratch as witch_oa_warp's. Refused (an error code) when
// no such cluster fits on the card at once.
template <int NPL>
static int launch_cluster_oa(const float *em_t, const float *tr_t, const int32_t *model_of,
                             const int32_t *ms, const int32_t *codes,
                             const int64_t *code_off, const int32_t *lens,
                             const float *pmoves, const int32_t *cta_pair,
                             const int64_t *roff, float *brows, float *bspec, uint8_t *ptr,
                             int32_t *rowk, uint8_t *rowf, int32_t *cols, float *stat,
                             int ncta, int K, int G, int C, int Mp, int Mpad,
                             cudaStream_t stream) {
    const size_t smem = warp_smem_bytes(G, Mpad / C, OA_WS_C);
    cudaError_t err = set_smem((const void *)oa_warp_kernel<NPL, true>, smem);
    if (err != cudaSuccess) return (int)err;
    err = launch_cluster(oa_warp_kernel<NPL, true>, ncta, C, OA_THREADS, smem, stream,
                         em_t, tr_t, model_of, ms, codes, code_off, lens, pmoves, cta_pair,
                         roff, brows, bspec, ptr, rowk, rowf, stat, K, G, Mpad, C);
    if (err != cudaSuccess) return (int)err;
    if (ncta > 0)
        oa_trace_kernel<<<(unsigned)((ncta + 127) / 128), 128, 0, stream>>>(
            cta_pair, ncta, code_off, lens, roff, ptr, rowk, rowf, cols, stat, Mp, Mpad);
    return (int)cudaGetLastError();
}

extern "C" int witch_oa_cluster(const float *em_t, const float *tr_t,
                                const int32_t *model_of, const int32_t *ms,
                                const int32_t *codes, const int64_t *code_off,
                                const int32_t *lens, const float *pmoves,
                                const int32_t *cta_pair, const int64_t *roff,
                                float *brows, float *bspec, uint8_t *ptr,
                                int32_t *rowk, uint8_t *rowf, int32_t *cols,
                                float *stat, int ncta, int K, int C, int npl,
                                int Mp, int Mpad, void *stream) {
    const int G = 8 * C;
    if (C < 2 || C > 8 || Mpad != 32 * G * npl || Mp > Mpad)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define OA_LAUNCH(NPL_)                                                                  \
    launch_cluster_oa<NPL_>(em_t, tr_t, model_of, ms, codes, code_off, lens, pmoves,      \
                            cta_pair, roff, brows, bspec, ptr, rowk, rowf, cols, stat,    \
                            ncta, K, G, C, Mp, Mpad, st)
    switch (npl) {
    case 8: return OA_LAUNCH(8);
    case 16: return OA_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
    }
#undef OA_LAUNCH
}

// Clusters of the cluster instance (C CTAs, npl states a lane) the card
// holds at once, or -error.
extern "C" int witch_oa_cluster_active(int C, int npl) {
    const int G = 8 * C;
    const size_t smem = warp_smem_bytes(G, 32 * G * npl / C, OA_WS_C);
    const void *fn = npl == 8 ? (const void *)oa_warp_kernel<8, true>
                              : (const void *)oa_warp_kernel<16, true>;
    cudaError_t err = set_smem(fn, smem);
    if (err != cudaSuccess) return -(int)err;
    return npl == 8 ? max_active_clusters(oa_warp_kernel<8, true>, C, OA_THREADS, smem)
                    : max_active_clusters(oa_warp_kernel<16, true>, C, OA_THREADS, smem);
}

// The first version: one CTA per pair, n pairs, scratch of Ldmax rows
// per pair. Returns a cudaError_t code.
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
