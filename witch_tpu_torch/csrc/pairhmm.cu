// Pair-HMM forward log-odds, one warp (or one CTA of G warps) per (A, B)
// pair.
//
// Replaces witch_tpu/ops/pairhmm_forward.py:pairhmm_forward_logodds (an
// XLA scan over the rows of A, with the in-row gap-in-A recurrence as an
// associative scan), which the consistency backbone aligner's opt-in
// device anchor embedding calls (backbone_consistency.py:
// _device_embedding). Recurrences and the plain version: ops/pairhmm.py.
//
// Bound: operations. The recurrence does 17 f32 operations a cell (the
// previous row's three values rescaled 3, M 5, X 3, Y 3, the row max 3;
// the scan of the chunks' affine maps comes on top) and a pair reads
// only its two code rows, so the work is LA * LB cells of arithmetic.
//
// Three kernels, picked by B's width (ops/pairhmm.py:pairhmm_layout):
//
// pairhmm_reg_kernel<CH> (LB + 1 <= 32 CH, CH in 8, 12, ..., 48, so B up
// to 1,535 residues: scenario A's and dna1k's pairs). One warp per pair
// and per CTA; lane l owns the CH columns j = l CH .. l CH + CH - 1.
//  - The previous row's M, X and Y live in the lane's registers (3 CH
//    floats, fully unrolled loops, no dynamic index), so a row reads
//    nothing back from memory that the same loop wrote: the first
//    version's in-place shared-memory rows made every cell's loads wait
//    on the stores before them. The one value left of a chunk comes from
//    lane - 1 by __shfl_up_sync before the row is updated.
//  - B's codes for the lane's columns (b[j - 1]) sit in CH / 4 registers
//    as packed byte offsets 4 c (so C <= 63); column 0 and the columns
//    past LB carry code C, a zero column appended to em [C, C + 1] in
//    shared memory, so M is 0 there without a test. The em lookup is one
//    byte extract and one shared-memory load whose address no earlier
//    load produces; A's code of the next row is loaded while the current
//    row runs.
//  - Y composes each chunk's affine maps, a warp scan gives the value
//    entering each chunk and a second pass applies them, as in the
//    first version; columns past LB hold no M or X and their Y is kept
//    out of the row max (one compare a cell).
//  - The rows' maxima wait one in each lane, and the lanes take the f64
//    logs of 32 rows at once: a log a row put a ~300-cycle serial f64
//    chain on every row's path. The f64 sum's order differs from the
//    first version's, far below f32's resolution.
//  - Occupancy is set by registers alone (em is C (C + 1) floats), and
//    registers by the 3 CH row values: 179 at CH 44 and 202 at CH 48,
//    none spilled (-Xptxas -v; tools/pairhmm_bench.py --ptxas and
//    chip_smoke.py 5c print each instance), 8 warps a SM (each of the
//    SM's 4 schedulers holds 2 such warps in its 16,384 registers). Kept
//    opaque once a row, the codes and t_mg stop the compiler holding CH
//    unpacked offsets and CH products t_mg m across the row loop (253
//    registers at CH 44 before).
//  - What bounds it: instruction issue, ~22 a cell (the 17 operations,
//    the em lookup, the Y mask and the chunk maps). On an H100 it runs
//    ~1.2e12 cells a second at 24,000 pairs (9e9 a SM), 3.4x its
//    operations bound (PERF.md).
//
// pairhmm_wide_kernel<CH> (B from 1,536 up to 8,191 residues, the
// PHW_COLS columns of the widest instance less one). The register
// design spread over one CTA of G warps per pair: lane l of warp w owns
// the CH columns from (32 w + l) CH, and keeps the register kernel's
// rows, packed code offsets, deferred maxima and batched f64 logs. G is
// set per launch by the widest B (G = ceil((LB + 1) / 32 CH)); the layout
// takes CH 24 at every width (ops/pairhmm.py:PHW_PICK_CH, measured
// against the other six instances, which tools/pairhmm_bench.py
// --layouts times). The warps meet twice a row at a CTA barrier,
// through per-warp records in shared memory kept by the row's parity:
//  - after pass 1 each warp's map of its 32 CH columns of Y (its
//    lanes' maps composed by the warp scan). Y entering warp w is the
//    composition of warps 0..w-1's maps applied to 0: a shuffle
//    reduction of those records in order (log2 G steps, no serial loop
//    over the records; lanes at or past w hold the identity);
//  - after pass 2 the warp's row max and its last column's M, X and Y:
//    the max over the G records rescales the next row, and warp w + 1's
//    lane 0 takes its diagonal (column j - 1 of the previous row) from
//    warp w's record, where the register kernel's lane 0 took 0.
//  A record of one parity is written only after the barrier that
//  follows every read of its previous contents, so no row's records
//  overwrite what a slow warp still reads. The carry across warps is
//  composed in full: t_gg^(32 CH) vanishes in f32 at eps 0.75, not at
//  eps near 1. A warp whose first column lies past the pair's own B
//  (G is set by the launch's widest B) skips both passes, posts the
//  identity map and a zero max, and still reaches every barrier; every
//  warp leaves the row loop at the pair's own len A together. Registers
//  set the instances (__launch_bounds__ caps them at 65,536 / 32 GMAX a
//  thread; 126 at CH 24, none spilled); tools/pairhmm_bench.py --ptxas
//  and chip_smoke.py 5w print each instance's registers and spills.
//  What bounds it: latency. At dnawide's widths (G 10) one CTA fits a
//  SM, and a CTA's row waits on its two barriers, the warp scan, the
//  G-record reduction and the max; it runs ~5.2e11 cells a second, 7.5x
//  its operations bound and half the register kernel's rate. Where two
//  CTAs fit a SM (G <= 8) it runs ~1.6x faster (PERF.md).
//
// pairhmm_kernel (the first version): PH_WARPS warps per CTA, one per
// pair; the columns j = 0..LB are cut into 32 contiguous chunks, one per
// lane. It stays for B rows wider than the wide layout's PHW_COLS and
// for C > 63, and for timing (first_version=True), as the first versions
// of the OA and flank kernels stay:
//  - the previous row's M, X and Y live in shared memory (a device buffer
//    of three rows per pair where they do not fit) and are updated in
//    place: a lane reads the one value left of its chunk into registers
//    before the warp barrier that precedes the update;
//  - B's codes, one byte each, are staged in shared memory where they
//    fit (a lane's chunk is 32 contiguous codes or more, so reading them
//    from device memory would take a cache line per lane every row);
//  - M reads the previous row's column j - 1, X its column j; the row's
//    Y is a first-order linear recurrence y_{j+1} = eps y_j + t_mg m_j
//    along the row: each lane composes the affine maps of its chunk, a
//    __shfl_up_sync scan gives the value entering each chunk, and a
//    second pass over the chunk writes Y and takes the row's max;
//  - em [C, C] in shared memory.
//
// Both rescale each row by its max, multiplying by the reciprocal when
// the next row reads the value (the plain version divides, which differs
// by an ulp per value; a division per value took the divide's slow path
// on the rows' subnormal tails), and sum the log scales in f64.
#include "common.cuh"

#define PH_WARPS 4
#define PH_THREADS (PH_WARPS * 32)

__global__ void __launch_bounds__(PH_THREADS)
pairhmm_kernel(const int32_t *__restrict__ codesA,
               const int32_t *__restrict__ lensA,
               const uint8_t *__restrict__ codesB,
               const int32_t *__restrict__ lensB,
               const float *__restrict__ em, float *__restrict__ out,
               float *__restrict__ rows_g, int codes_smem, int P, int LAs,
               int LBs, int C, float t_mm, float t_mg, float t_gm,
               float t_gg) {
    extern __shared__ float sm[];
    float *em_s = sm;
    const int W = LBs + 1;
    for (int t = threadIdx.x; t < C * C; t += PH_THREADS) em_s[t] = em[t];
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = blockIdx.x * PH_WARPS + warp;
    if (p >= P) return;               // no CTA barrier below
    float *rows_s = sm + C * C;
    float *rM = rows_g ? rows_g + (size_t)p * 3 * W
                       : rows_s + (size_t)warp * 3 * W;
    float *rX = rM + W, *rY = rX + W;
    const int LA = lensA[p], LB = lensB[p];
    const int32_t *a = codesA + (size_t)p * LAs;
    const uint8_t *b = codesB + (size_t)p * LBs;
    if (codes_smem) {
        uint8_t *bs = (uint8_t *)(rows_s + (rows_g ? 0 : PH_WARPS * 3 * W))
                      + (size_t)warp * LBs;
        for (int j = lane; j < LB; j += 32) bs[j] = b[j];
        b = bs;
    }
    const int n = LB + 1, ch = (n + 31) / 32;
    const int j0 = min(n, lane * ch), j1 = min(n, j0 + ch);

    // row 0: M[0, 0] = 1, X = 0, Y[0, j] = t_mg t_gg^(j-1)
    for (int j = j0; j < j1; ++j) {
        rM[j] = j == 0 ? 1.f : 0.f;
        rX[j] = 0.f;
        rY[j] = j == 0 ? 0.f : t_mg * powf(t_gg, (float)(j - 1));
    }
    float inv = 1.f;                  // 1 / the stored row's max
    double logs = 0.0;
    __syncwarp();

    for (int i = 0; i < LA; ++i) {
        const float *erow = em_s + a[i] * C;
        float pM = 0.f, pX = 0.f, pY = 0.f;   // previous row, column j - 1
        if (j0 > 0 && j0 < j1) {
            pM = rM[j0 - 1] * inv;
            pX = rX[j0 - 1] * inv;
            pY = rY[j0 - 1] * inv;
        }
        __syncwarp();
        // pass 1: M and X in place; the chunk's map y_{j0} -> y_{j1}
        Aff f{1.f, 0.f};
        for (int j = j0; j < j1; ++j) {
            const float oM = rM[j] * inv, oX = rX[j] * inv, oY = rY[j] * inv;
            const float m = j == 0 ? 0.f
                : erow[b[j - 1]] * (t_mm * pM + t_gm * pX + t_gm * pY);
            rM[j] = m;
            rX[j] = t_mg * oM + t_gg * oX;
            pM = oM;
            pX = oX;
            pY = oY;
            f = aff_then(f, Aff{t_gg, t_mg * m});
        }
        // the value of Y entering each chunk (Y[i, 0] = 0)
        Aff x = f;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const float qa = __shfl_up_sync(FULL_MASK, x.a, s);
            const float qb = __shfl_up_sync(FULL_MASK, x.b, s);
            if (lane >= s) x = aff_then(Aff{qa, qb}, x);
        }
        float y = __shfl_up_sync(FULL_MASK, x.b, 1);
        if (lane == 0) y = 0.f;
        // pass 2: Y and the row's max
        float rmax = 0.f;
        for (int j = j0; j < j1; ++j) {
            const float m = rM[j];
            rY[j] = y;
            rmax = fmaxf(rmax, fmaxf(m, fmaxf(rX[j], y)));
            y = t_gg * y + t_mg * m;
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            rmax = fmaxf(rmax, __shfl_xor_sync(FULL_MASK, rmax, s));
        const float mx = rmax <= 0.f ? 1.f : rmax;
        inv = 1.f / mx;
        logs += log((double)mx);
        __syncwarp();
    }
    if (LB >= j0 && LB < j1) {
        const float tot = rM[LB] * inv + rX[LB] * inv + rY[LB] * inv;
        out[p] = (float)((double)logf(fmaxf(tot, 1e-30f)) + logs);
    }
}

// Dynamic shared memory of a CTA: em, then (unless rows_g) the warps'
// three rows, then (if codes_smem) the warps' B codes.
static size_t pairhmm_smem(int C, int LBs, bool rows_in_smem,
                           bool codes_smem) {
    size_t bytes = (size_t)C * C * sizeof(float);
    if (rows_in_smem)
        bytes += (size_t)PH_WARPS * 3 * (LBs + 1) * sizeof(float);
    if (codes_smem) bytes += (size_t)PH_WARPS * LBs;
    return bytes;
}

extern "C" int witch_pairhmm(const int32_t *codesA, const int32_t *lensA,
                             const uint8_t *codesB, const int32_t *lensB,
                             const float *em, float *out, float *rows_g,
                             int codes_smem, int P, int LAs, int LBs, int C,
                             float t_mm, float t_mg, float t_gm, float t_gg,
                             void *stream) {
    const size_t smem = pairhmm_smem(C, LBs, rows_g == nullptr, codes_smem);
    cudaError_t err = set_smem((const void *)pairhmm_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    if (P <= 0) return 0;
    pairhmm_kernel<<<(unsigned)((P + PH_WARPS - 1) / PH_WARPS), PH_THREADS,
                     smem, (cudaStream_t)stream>>>(
        codesA, lensA, codesB, lensB, em, out, rows_g, codes_smem, P, LAs,
        LBs, C, t_mm, t_mg, t_gm, t_gg);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The register kernel: one warp per pair and per CTA, CH columns a lane.

// Value left of the lane's chunk in the previous row, rescaled (0 for
// lane 0, whose chunk starts at column 0).
static __device__ __forceinline__ float left_of(float v, float inv,
                                                int lane) {
    const float u = __shfl_up_sync(FULL_MASK, v, 1) * inv;
    return lane == 0 ? 0.f : u;
}

// v, as a value the compiler cannot see through: taken once a row, it
// keeps the compiler from holding CH values across the row loop (the
// codes' byte offsets unpacked, each t_mg m of pass 1 for pass 2), which
// took up to 253 registers a lane and 8 warps a SM at CH 44.
static __device__ __forceinline__ uint32_t opaque(uint32_t v) {
    asm volatile("" : "+r"(v));
    return v;
}
static __device__ __forceinline__ float opaque(float v) {
    asm volatile("" : "+f"(v));
    return v;
}

template <int CH>
__global__ void __launch_bounds__(32)
pairhmm_reg_kernel(const int32_t *__restrict__ codesA,
                   const int32_t *__restrict__ lensA,
                   const uint8_t *__restrict__ codesB,
                   const int32_t *__restrict__ lensB,
                   const float *__restrict__ em, float *__restrict__ out,
                   int LAs, int LBs, int C, float t_mm, float t_mg,
                   float t_gm, float t_gg) {
    static_assert(CH % 4 == 0, "codes are packed four to a register");
    extern __shared__ float em_s[];       // [C, C + 1]; column C is 0
    const int lane = threadIdx.x, W = C + 1;
    for (int t = lane; t < C * W; t += 32) {
        const int r = t / W, c = t - r * W;
        em_s[t] = c < C ? em[r * C + c] : 0.f;
    }
    __syncthreads();
    const int p = blockIdx.x;
    const int LA = lensA[p], LB = lensB[p];
    const int32_t *a = codesA + (size_t)p * LAs;
    const uint8_t *b = codesB + (size_t)p * LBs;
    const int jb = lane * CH;             // the lane's first column
    const int lim = LB + 1 - jb;          // its columns k < lim are in B

    // byte offset in an em row of column j's B code b[j - 1] (4 C <= 252);
    // code C, em's zero column, at j = 0 and past LB
    uint32_t cw[CH / 4];
#pragma unroll
    for (int q = 0; q < CH / 4; ++q) {
        uint32_t w = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int j = jb + 4 * q + r;
            const uint32_t c = (j >= 1 && j <= LB) ? (uint32_t)b[j - 1]
                                                   : (uint32_t)C;
            w |= (4 * c) << (8 * r);
        }
        cw[q] = w;
    }

    // row 0: M[0, 0] = 1, X = 0, Y[0, j] = t_mg t_gg^(j-1)
    float M[CH], X[CH], Y[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
        const int j = jb + k;
        M[k] = j == 0 ? 1.f : 0.f;
        X[k] = 0.f;
        Y[k] = (j >= 1 && j <= LB) ? t_mg * powf(t_gg, (float)(j - 1))
                                   : 0.f;
    }
    float inv = 1.f;                      // 1 / the stored row's max
    // the rows' log scales: row i's max waits in lane i % 32 and the
    // lanes take the logs of 32 rows at once, in f64 (a log a row on
    // the row's path cost ~300 cycles of a serial f64 chain)
    float held = 1.f;
    double logs = 0.0;
    int ai = LA > 0 ? a[0] : 0;

    for (int i = 0; i < LA; ++i) {
        const int an = i + 1 < LA ? a[i + 1] : 0;
        const char *erow = (const char *)(em_s + ai * W);
        const float tmg = opaque(t_mg);
#pragma unroll
        for (int q = 0; q < CH / 4; ++q) cw[q] = opaque(cw[q]);
        // previous row, column j - 1
        float pM = left_of(M[CH - 1], inv, lane);
        float pX = left_of(X[CH - 1], inv, lane);
        float pY = left_of(Y[CH - 1], inv, lane);
        // pass 1: M and X, their maxima; the chunk's map y_{jb} ->
        // y_{jb + CH}
        Aff f{1.f, 0.f};
        float mxM = 0.f, mxX = 0.f;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
            const float oM = M[k] * inv, oX = X[k] * inv, oY = Y[k] * inv;
            const float e = *(const float *)(
                erow + __byte_perm(cw[k >> 2], 0, 0x4440 + (k & 3)));
            const float m = e * (t_mm * pM + t_gm * pX + t_gm * pY);
            const float x = t_mg * oM + t_gg * oX;
            M[k] = m;
            X[k] = x;
            mxM = fmaxf(mxM, m);
            mxX = fmaxf(mxX, x);
            pM = oM;
            pX = oX;
            pY = oY;
            f = aff_then(f, Aff{t_gg, t_mg * m});
        }
        // the value of Y entering each chunk (Y[i, 0] = 0)
        Aff x = f;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const float qa = __shfl_up_sync(FULL_MASK, x.a, s);
            const float qb = __shfl_up_sync(FULL_MASK, x.b, s);
            if (lane >= s) x = aff_then(Aff{qa, qb}, x);
        }
        float y = __shfl_up_sync(FULL_MASK, x.b, 1);
        if (lane == 0) y = 0.f;
        // pass 2: Y and its max over the columns in B (M and X are 0
        // past LB)
        float mxY = 0.f;
#pragma unroll
        for (int k = 0; k < CH; ++k) {
            Y[k] = y;
            if (k < lim) mxY = fmaxf(mxY, y);
            y = t_gg * y + tmg * M[k];
        }
        float rmax = fmaxf(mxM, fmaxf(mxX, mxY));
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            rmax = fmaxf(rmax, __shfl_xor_sync(FULL_MASK, rmax, s));
        const float mx = rmax <= 0.f ? 1.f : rmax;
        inv = __frcp_rn(mx);
        if (lane == (i & 31)) held = mx;
        if ((i & 31) == 31 || i == LA - 1) {
            logs += log((double)held);
            held = 1.f;
        }
        ai = an;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        logs += __shfl_xor_sync(FULL_MASK, logs, s);
    const int kk = LB - jb;
    if (kk >= 0 && kk < CH) {
        float vM = 0.f, vX = 0.f, vY = 0.f;
#pragma unroll
        for (int k = 0; k < CH; ++k)
            if (k == kk) {
                vM = M[k];
                vX = X[k];
                vY = Y[k];
            }
        const float tot = vM * inv + vX * inv + vY * inv;
        out[p] = (float)((double)logf(fmaxf(tot, 1e-30f)) + logs);
    }
}

template <int CH>
static int launch_reg(const int32_t *codesA, const int32_t *lensA,
                      const uint8_t *codesB, const int32_t *lensB,
                      const float *em, float *out, int P, int LAs, int LBs,
                      int C, float t_mm, float t_mg, float t_gm, float t_gg,
                      cudaStream_t stream) {
    const size_t smem = (size_t)C * (C + 1) * sizeof(float);
    cudaError_t err = set_smem((const void *)pairhmm_reg_kernel<CH>, smem);
    if (err != cudaSuccess) return (int)err;
    pairhmm_reg_kernel<CH><<<(unsigned)P, 32, smem, stream>>>(
        codesA, lensA, codesB, lensB, em, out, LAs, LBs, C, t_mm, t_mg, t_gm,
        t_gg);
    return (int)cudaGetLastError();
}

// The register kernel at CH columns a lane (8, 12, ..., 48: ops/
// pairhmm.py:PH_CH); C <= 63 (B's codes are held as byte offsets 4 c,
// and code C marks the columns without a B residue).
extern "C" int witch_pairhmm_reg(const int32_t *codesA, const int32_t *lensA,
                                 const uint8_t *codesB, const int32_t *lensB,
                                 const float *em, float *out, int CH, int P,
                                 int LAs, int LBs, int C, float t_mm,
                                 float t_mg, float t_gm, float t_gg,
                                 void *stream) {
    if (C < 1 || C > 63 || (LBs + 1 > 32 * CH && P > 0))
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define PH_REG(N)                                                             \
    case N:                                                                   \
        return launch_reg<N>(codesA, lensA, codesB, lensB, em, out, P, LAs,   \
                             LBs, C, t_mm, t_mg, t_gm, t_gg, st);
    switch (CH) {
        PH_REG(8)
        PH_REG(12)
        PH_REG(16)
        PH_REG(20)
        PH_REG(24)
        PH_REG(28)
        PH_REG(32)
        PH_REG(36)
        PH_REG(40)
        PH_REG(44)
        PH_REG(48)
    }
#undef PH_REG
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// The wide layout: one CTA of G warps per pair, CH columns a lane.

#define PHW_COLS 8192   // columns j = 0..LB the wide instances reach

// The most warps a CTA of the CH instance takes: enough for PHW_COLS
// columns. __launch_bounds__ caps its registers at 65,536 / (32 GMAX).
template <int CH>
struct PhwMax {
    static constexpr int G = (PHW_COLS + 32 * CH - 1) / (32 * CH);
};

// The value left of the lane's chunk in the previous row, rescaled: from
// lane - 1, or for lane 0 from warp - 1's record (0 in warp 0).
static __device__ __forceinline__ float left_of_wide(float v, float rec,
                                                     float inv, int lane,
                                                     int warp) {
    const float u = __shfl_up_sync(FULL_MASK, v, 1);
    return lane > 0 ? u * inv : (warp > 0 ? rec * inv : 0.f);
}

template <int CH>
__global__ void __launch_bounds__(32 * PhwMax<CH>::G)
pairhmm_wide_kernel(const int32_t *__restrict__ codesA,
                    const int32_t *__restrict__ lensA,
                    const uint8_t *__restrict__ codesB,
                    const int32_t *__restrict__ lensB,
                    const float *__restrict__ em, float *__restrict__ out,
                    int G, int LAs, int LBs, int C, float t_mm, float t_mg,
                    float t_gm, float t_gg) {
    static_assert(CH % 4 == 0, "codes are packed four to a register");
    constexpr int GMAX = PhwMax<CH>::G;
    extern __shared__ float em_s[];       // [C, C + 1]; column C is 0
    // per warp, by the parity of the row that wrote it: its last column's
    // M, X and Y and its row max; its map of Y over its columns
    __shared__ float4 rec[2][GMAX];
    __shared__ Aff ymap[2][GMAX];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = C + 1;
    for (int t = threadIdx.x; t < C * W; t += 32 * G) {
        const int r = t / W, c = t - r * W;
        em_s[t] = c < C ? em[r * C + c] : 0.f;
    }
    const int p = blockIdx.x;
    const int LA = lensA[p], LB = lensB[p];
    const int32_t *a = codesA + (size_t)p * LAs;
    const uint8_t *b = codesB + (size_t)p * LBs;
    const int jb = (32 * warp + lane) * CH;   // the lane's first column
    const int lim = LB + 1 - jb;          // its columns k < lim are in B
    const bool live = 32 * warp * CH <= LB;   // the warp holds a column

    // byte offset in an em row of column j's B code b[j - 1] (4 C <= 252);
    // code C, em's zero column, at j = 0 and past LB
    uint32_t cw[CH / 4];
#pragma unroll
    for (int q = 0; q < CH / 4; ++q) {
        uint32_t w = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int j = jb + 4 * q + r;
            const uint32_t c = (j >= 1 && j <= LB) ? (uint32_t)b[j - 1]
                                                   : (uint32_t)C;
            w |= (4 * c) << (8 * r);
        }
        cw[q] = w;
    }

    // row 0: M[0, 0] = 1, X = 0, Y[0, j] = t_mg t_gg^(j-1)
    float M[CH], X[CH], Y[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
        const int j = jb + k;
        M[k] = j == 0 ? 1.f : 0.f;
        X[k] = 0.f;
        Y[k] = (j >= 1 && j <= LB) ? t_mg * powf(t_gg, (float)(j - 1))
                                   : 0.f;
    }
    if (lane == 31)
        rec[0][warp] = make_float4(M[CH - 1], X[CH - 1], Y[CH - 1], 0.f);
    __syncthreads();
    float inv = 1.f;                      // 1 / the stored row's max
    float held = 1.f;                     // row i's max, in lane i % 32
    double logs = 0.0;
    int ai = LA > 0 ? a[0] : 0;

    for (int i = 0; i < LA; ++i) {
        const int cur = i & 1, nxt = cur ^ 1;
        const int an = i + 1 < LA ? a[i + 1] : 0;
        const float tmg = opaque(t_mg);
        Aff x{1.f, 0.f};          // the maps of the warp's lanes up to this
        float mxM = 0.f, mxX = 0.f, mxY = 0.f;
        if (live) {
            const char *erow = (const char *)(em_s + ai * W);
#pragma unroll
            for (int q = 0; q < CH / 4; ++q) cw[q] = opaque(cw[q]);
            // previous row, column j - 1
            const float4 lw = (lane == 0 && warp > 0)
                                  ? rec[cur][warp - 1]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
            float pM = left_of_wide(M[CH - 1], lw.x, inv, lane, warp);
            float pX = left_of_wide(X[CH - 1], lw.y, inv, lane, warp);
            float pY = left_of_wide(Y[CH - 1], lw.z, inv, lane, warp);
            // pass 1: M and X, their maxima; the chunk's map y_{jb} ->
            // y_{jb + CH}
            Aff f{1.f, 0.f};
#pragma unroll
            for (int k = 0; k < CH; ++k) {
                const float oM = M[k] * inv, oX = X[k] * inv,
                            oY = Y[k] * inv;
                const float e = *(const float *)(
                    erow + __byte_perm(cw[k >> 2], 0, 0x4440 + (k & 3)));
                const float m = e * (t_mm * pM + t_gm * pX + t_gm * pY);
                const float xx = t_mg * oM + t_gg * oX;
                M[k] = m;
                X[k] = xx;
                mxM = fmaxf(mxM, m);
                mxX = fmaxf(mxX, xx);
                pM = oM;
                pX = oX;
                pY = oY;
                f = aff_then(f, Aff{t_gg, t_mg * m});
            }
            x = f;
#pragma unroll
            for (int s = 1; s < 32; s <<= 1) {
                const float qa = __shfl_up_sync(FULL_MASK, x.a, s);
                const float qb = __shfl_up_sync(FULL_MASK, x.b, s);
                if (lane >= s) x = aff_then(Aff{qa, qb}, x);
            }
        }
        if (lane == 31) ymap[cur][warp] = x;
        __syncthreads();                  // meeting 1: the warps' maps
        if (live) {
            // Y entering the warp: warps 0..warp-1's maps composed in
            // order (lane g holds warp g's; the identity at g >= warp),
            // applied to Y[i, 0] = 0
            Aff g = lane < warp ? ymap[cur][lane] : Aff{1.f, 0.f};
            for (int s = 1; s < warp; s <<= 1) {
                const float qa = __shfl_down_sync(FULL_MASK, g.a, s);
                const float qb = __shfl_down_sync(FULL_MASK, g.b, s);
                if (lane + s < 32) g = aff_then(g, Aff{qa, qb});
            }
            const float yin = __shfl_sync(FULL_MASK, g.b, 0);
            // ... and entering the lane's chunk
            const float ea = __shfl_up_sync(FULL_MASK, x.a, 1);
            const float eb = __shfl_up_sync(FULL_MASK, x.b, 1);
            float y = lane == 0 ? yin : ea * yin + eb;
            // pass 2: Y and its max over the columns in B (M and X are 0
            // past LB)
#pragma unroll
            for (int k = 0; k < CH; ++k) {
                Y[k] = y;
                if (k < lim) mxY = fmaxf(mxY, y);
                y = t_gg * y + tmg * M[k];
            }
        }
        float wmax = fmaxf(mxM, fmaxf(mxX, mxY));
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            wmax = fmaxf(wmax, __shfl_xor_sync(FULL_MASK, wmax, s));
        if (lane == 31)
            rec[nxt][warp] = make_float4(M[CH - 1], X[CH - 1], Y[CH - 1],
                                         wmax);
        __syncthreads();                  // meeting 2: maxima, diagonals
        float rmax = lane < G ? rec[nxt][lane].w : 0.f;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            rmax = fmaxf(rmax, __shfl_xor_sync(FULL_MASK, rmax, s));
        const float mx = rmax <= 0.f ? 1.f : rmax;
        inv = __frcp_rn(mx);
        if (lane == (i & 31)) held = mx;
        if ((i & 31) == 31 || i == LA - 1) {
            logs += log((double)held);
            held = 1.f;
        }
        ai = an;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        logs += __shfl_xor_sync(FULL_MASK, logs, s);
    const int kk = LB - jb;
    if (kk >= 0 && kk < CH) {
        float vM = 0.f, vX = 0.f, vY = 0.f;
#pragma unroll
        for (int k = 0; k < CH; ++k)
            if (k == kk) {
                vM = M[k];
                vX = X[k];
                vY = Y[k];
            }
        const float tot = vM * inv + vX * inv + vY * inv;
        out[p] = (float)((double)logf(fmaxf(tot, 1e-30f)) + logs);
    }
}

template <int CH>
static int launch_wide(const int32_t *codesA, const int32_t *lensA,
                       const uint8_t *codesB, const int32_t *lensB,
                       const float *em, float *out, int G, int P, int LAs,
                       int LBs, int C, float t_mm, float t_mg, float t_gm,
                       float t_gg, cudaStream_t stream) {
    if (G > PhwMax<CH>::G) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)C * (C + 1) * sizeof(float);
    cudaError_t err = set_smem((const void *)pairhmm_wide_kernel<CH>, smem);
    if (err != cudaSuccess) return (int)err;
    pairhmm_wide_kernel<CH><<<(unsigned)P, 32 * G, smem, stream>>>(
        codesA, lensA, codesB, lensB, em, out, G, LAs, LBs, C, t_mm, t_mg,
        t_gm, t_gg);
    return (int)cudaGetLastError();
}

template <int CH>
static int wide_ctas(int G, int C, int *ctas) {
    const size_t smem = (size_t)C * (C + 1) * sizeof(float);
    cudaError_t err = set_smem((const void *)pairhmm_wide_kernel<CH>, smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, pairhmm_wide_kernel<CH>, 32 * G, smem);
}

// CTAs of the wide CH instance at G warps that one SM keeps resident,
// into *ctas (tools/pairhmm_bench.py and chip_smoke.py 5w print it).
extern "C" int witch_pairhmm_wide_ctas_per_sm(int CH, int G, int C,
                                              int *ctas) {
    switch (CH) {
    case 8: return wide_ctas<8>(G, C, ctas);
    case 12: return wide_ctas<12>(G, C, ctas);
    case 16: return wide_ctas<16>(G, C, ctas);
    case 20: return wide_ctas<20>(G, C, ctas);
    case 24: return wide_ctas<24>(G, C, ctas);
    case 28: return wide_ctas<28>(G, C, ctas);
    case 32: return wide_ctas<32>(G, C, ctas);
    }
    return (int)cudaErrorInvalidValue;
}

// The wide layout at CH columns a lane (ops/pairhmm.py:PHW_CH) and G
// warps a pair, 32 G CH >= LBs + 1, G at most the instance's PhwMax;
// C <= 63 as for the register kernel.
extern "C" int witch_pairhmm_wide(const int32_t *codesA,
                                  const int32_t *lensA,
                                  const uint8_t *codesB,
                                  const int32_t *lensB, const float *em,
                                  float *out, int CH, int G, int P, int LAs,
                                  int LBs, int C, float t_mm, float t_mg,
                                  float t_gm, float t_gg, void *stream) {
    if (C < 1 || C > 63 || G < 1 || (LBs + 1 > 32 * G * CH && P > 0))
        return (int)cudaErrorInvalidValue;
    if (P <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
#define PH_WIDE(N)                                                            \
    case N:                                                                   \
        return launch_wide<N>(codesA, lensA, codesB, lensB, em, out, G, P,    \
                              LAs, LBs, C, t_mm, t_mg, t_gm, t_gg, st);
    switch (CH) {
        PH_WIDE(8)
        PH_WIDE(12)
        PH_WIDE(16)
        PH_WIDE(20)
        PH_WIDE(24)
        PH_WIDE(28)
        PH_WIDE(32)
    }
#undef PH_WIDE
    return (int)cudaErrorInvalidValue;
}
