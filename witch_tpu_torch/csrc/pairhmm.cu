// Pair-HMM forward log-odds, one warp per (A, B) pair.
//
// Replaces witch_tpu/ops/pairhmm_forward.py:pairhmm_forward_logodds (an
// XLA scan over the rows of A, with the in-row gap-in-A recurrence as an
// associative scan), which the consistency backbone aligner's opt-in
// device anchor embedding calls (backbone_consistency.py:
// _device_embedding). Recurrences and the plain version: ops/pairhmm.py.
//
// Bound: operations. The recurrence does 17 f32 operations a cell (the
// previous row's three values rescaled 3, M 5, X 3, Y 3, the row max 3;
// this kernel's scan of its chunks' affine maps comes on top) and a pair
// reads only its two code rows, so the work is LA * LB cells of
// arithmetic; the rows are never written to device memory unless they do
// not fit in shared memory.
//
// Design (a first version):
//  - one warp per pair, PH_WARPS pairs per CTA; the columns j = 0..LB of
//    the pair's own B are cut into 32 contiguous chunks, one per lane;
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
//  - the row's rescale (a multiply by the reciprocal of its max; the
//    plain version divides, which differs by an ulp per value) is
//    applied when the next row reads it; the log scales sum in f64. A
//    division per value took the divide's slow path on the rows'
//    subnormal tails;
//  - em [C, C] in shared memory.
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
