// Multihit flank posterior rows for the reporting gate prefilter, one
// CTA per (model, query) pair of an all-vs-all grid.
//
// Replaces: witch_tpu/hmm/flank_device.py:_flank_one (vmapped by
// flank_rows_bank; XLA scans, not a Pallas kernel), the device half of
// prefilter_grid under --full-search-results.
//
// Per pair: a multihit Forward over the query, rescaled per row by
// max(max M, C, N) with a 1e-35 floor, storing each row's log specials
// (N B J C E, plus the running log scale) to a device scratch; then the
// Backward from the terminal row L down to row 0 with the same rescale,
// combining each row's log specials with the stored Forward ones into
//   ppB[i] = exp(fB[i] + bB[i] - fwd),  ppE[i] = exp(fE[i] + bE[i] - fwd),
//   mocc[i] = 1 - (ppN + ppJ + ppC)[i],  ppX[i] = exp(fX[i-1] + ln loop
//             + bX[i] - fwd),
// with numpy.nan_to_num semantics, rows past the query length zeroed
// (flank_device.py:182-197). Row arithmetic is f32 as on the TPU.
//
// What bounds it on an H100: as forward.cu, per-row barrier latency and
// the L1/L2 reads of the model tables, over 2 * L rows per pair (Forward
// and Backward); the outputs are 3 * (L + 1) floats per pair.
//
// Design: the working rows (3 * Mp floats, 197 KB at Mp = 16,416, the
// 16,384-state cap) live in shared memory and are updated in place with
// the row helpers of common.cuh: the block scan of affine maps for both
// delete chains (the Backward chain runs right to left with tdd
// unshifted, D[k] = tdd[k] D[k+1] + c[k]) and the Backward row step. The
// multihit Backward E state needs the B-state sum of the row before the
// delete chain, so each Backward row does one extra block reduction. A
// model too wide for shared memory (Mp above ~19,000, beyond the cap)
// makes the launch fail, and the wrapper raises.

#include <float.h>
#include <math.h>

#include "common.cuh"

static constexpr float FLANK_FLOOR = 1e-35f;   // flank_device.py:93,143

// numpy.nan_to_num for f32: NaN -> 0, +-inf -> +-FLT_MAX
static __device__ __forceinline__ float nan0(float x) {
    if (isnan(x)) return 0.f;
    if (isinf(x)) return x > 0.f ? FLT_MAX : -FLT_MAX;
    return x;
}

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
