// Per-envelope null2-by-expectation for the reporting gate, one CTA per
// envelope.
//
// Replaces: witch_tpu/ops/pallas_null2.py:_null2_kernel (the TPU kernel
// reached from null2_envelopes_device).
//
// Computes, per envelope (model h, envelope subsequence of length Ld,
// full target length L): the isolated unihit Forward over the envelope
// with pmove = 2/(L+2) (envsc, nats), then a Backward that accumulates
// the posterior state usage: useM[k], useI = sum ppI, usetot = sum ppM +
// sum ppI, and n2dot[x] = sum_k useM[k] * em[h, x, k].
//
// What bounds it on an H100: like forward.cu, per-row barrier latency
// and table reads; in addition every Forward row (M and I, 2 * Mp
// floats) is written to device memory and read back once by the
// Backward, about 2 * 2 * 4 * Mp * Ld bytes per envelope (~20 MB at
// Mp = 2816, Ld = 448), which stays in L2 for a few hundred CTAs.
//
// Design: the TPU kernel checkpointed every 32 rows because its fast
// memory was small; here the Forward rows of a chunk of envelopes go
// straight to a device scratch buffer [n_chunk, Ld+1, 2, Mp] (the
// wrapper sizes the chunk), and the Backward reads them back: no
// recomputation. Row updates, delete chains and rescaling follow
// forward.cu (common.cuh). The four working rows (16 * Mp bytes) live in
// shared memory up to Mp ~14,400; for wider models (up to the 16,384-
// state cap) the wrapper passes `rows_g`, and each CTA keeps them in its
// own slice of that device buffer instead (L1/L2-cached). The layout is a
// template parameter, so the shared-memory instance keeps shared-memory
// addressing.

#include "common.cuh"

template <bool kDevRows>
__global__ void null2_kernel(const float *__restrict__ em,
                             const float *__restrict__ trans,
                             const int32_t *__restrict__ model_of,
                             const int32_t *__restrict__ codes,
                             const int64_t *__restrict__ code_off,
                             const int32_t *__restrict__ lds,
                             const float *__restrict__ pmoves,
                             float *__restrict__ rows,
                             float *__restrict__ fled,
                             float *__restrict__ scal,
                             float *__restrict__ n2dot,
                             float *__restrict__ rows_g, int Mp, int K,
                             int Ldmax) {
    extern __shared__ float smem[];
    float *base = kDevRows ? rows_g + (size_t)blockIdx.x * 4 * Mp : smem;
    float *sM = base, *sI = base + Mp, *sD = base + 2 * Mp,
          *sU = base + 3 * Mp;
    __shared__ Aff shA[NWARP];
    __shared__ float shR[2 * NWARP];
    const int en = blockIdx.x;
    const int h = model_of[en];
    const float *tr = trans + (size_t)h * 8 * Mp;
    const float *emh = em + (size_t)h * K * Mp;
    const int Ld = lds[en];
    const int32_t *cs = codes + code_off[en];
    const float pmove = pmoves[en];
    const float ploop = 1.0f - pmove;
    float *R = rows + (size_t)blockIdx.x * (Ldmax + 1) * 2 * Mp;
    float *FL = fled + (size_t)blockIdx.x * (Ldmax + 1);

    int k0, k1;
    chunk_of(Mp, k0, k1);
    for (int k = k0; k < k1; ++k) {
        sM[k] = 0.f;
        sI[k] = 0.f;
        sD[k] = 0.f;
        sU[k] = 0.f;
    }
    // ---- Forward, rows stored ----
    float N = 1.f, B = pmove, C = 0.f, logs = 0.f;
    for (int i = 1; i <= Ld; ++i) {
        __syncthreads();
        const float *e = emh + (size_t)cs[i - 1] * Mp;
        float s, mx;
        forward_core_row(sM, sI, sD, tr, e, B, Mp, s, mx, shA);
        block_sum_max(s, mx, shR);
        const float Cn = C * ploop + s;     // unihit: E -> C = 1
        const float Nn = N * ploop;
        const float Bn = Nn * pmove;
        const float scale = fmaxf(mx, fmaxf(Cn, fmaxf(Nn, SCALE_FLOOR)));
        const float inv = 1.0f / scale;
        float *Ri = R + (size_t)i * 2 * Mp;
        for (int k = k0; k < k1; ++k) {
            sM[k] *= inv;
            sI[k] *= inv;
            sD[k] *= inv;
            Ri[k] = sM[k];
            Ri[Mp + k] = sI[k];
        }
        N = Nn * inv;
        B = Bn * inv;
        C = Cn * inv;
        logs = logs + logf(scale);
        if (threadIdx.x == 0) FL[i] = logs;
    }
    const float envsc = logf(fmaxf(C, SCALE_FLOOR)) + logf(pmove) + logs;
    __syncthreads();   // FL visible to every thread

    // ---- Backward from the terminal row, accumulating usage ----
    float *bM = sM, *bI = sI;
    backward_terminal_row(bM, bI, sD, tr, pmove, Mp, shA);
    float bN = 0.f, bC = pmove, bled = 0.f;
    float useI = 0.f, usetot = 0.f;
    for (int i = Ld; i >= 1; --i) {
        __syncthreads();
        if (i < Ld) {
            const float *e = emh + (size_t)cs[i] * Mp;   // residue i+1
            const float bCn = bC * ploop;
            float pB, mx;
            backward_core_row(bM, bI, sD, tr, e, bCn, Mp, pB, mx, shA);
            block_sum_max(pB, mx, shR);
            const float bNn = bN * ploop + pB * pmove;
            const float scale =
                fmaxf(mx, fmaxf(bNn, fmaxf(bCn, SCALE_FLOOR)));
            const float inv = 1.0f / scale;
            scale_rows(bM, bI, nullptr, inv, Mp);
            bN = bNn * inv;
            bC = bCn * inv;
            bled = bled + logf(scale);
        }
        const float sc = expf(FL[i] + bled - envsc);
        const float *Ri = R + (size_t)i * 2 * Mp;
        float pI = 0.f, pM = 0.f;
        for (int k = k0; k < k1; ++k) {
            const float ppM = Ri[k] * bM[k] * sc;
            const float ppI = Ri[Mp + k] * bI[k] * sc;
            sU[k] += ppM;
            pM += ppM;
            pI += ppI;
        }
        block_sum2(pI, pM, shR);
        useI = useI + pI;
        usetot = usetot + pI + pM;
    }
    if (threadIdx.x == 0) {
        scal[(size_t)en * 3 + 0] = envsc;
        scal[(size_t)en * 3 + 1] = useI;
        scal[(size_t)en * 3 + 2] = usetot;
    }
    // n2dot[x] = sum_k useM[k] em[x, k]
    for (int x = 0; x < K; ++x) {
        const float *ex = emh + (size_t)x * Mp;
        float p = 0.f;
        for (int k = k0; k < k1; ++k) p += sU[k] * ex[k];
        p = block_reduce(p, OpSum(), shR);
        if (threadIdx.x == 0) n2dot[(size_t)en * 128 + x] = p;
    }
}

extern "C" int witch_null2(const float *em, const float *trans,
                           const int32_t *model_of, const int32_t *codes,
                           const int64_t *code_off, const int32_t *lds,
                           const float *pmoves, float *rows, float *fled,
                           float *scal, float *n2dot, float *rows_g, int n,
                           int Mp, int K, int Ldmax, void *stream) {
    if (rows_g) {
        if (n > 0)
            null2_kernel<true><<<(unsigned)n, NT, 0, (cudaStream_t)stream>>>(
                em, trans, model_of, codes, code_off, lds, pmoves, rows, fled,
                scal, n2dot, rows_g, Mp, K, Ldmax);
        return (int)cudaGetLastError();
    }
    const size_t smem = (size_t)4 * Mp * sizeof(float);
    cudaError_t err = set_smem((const void *)null2_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    if (n > 0)
        null2_kernel<false><<<(unsigned)n, NT, smem, (cudaStream_t)stream>>>(
            em, trans, model_of, codes, code_off, lds, pmoves, rows, fled,
            scal, n2dot, nullptr, Mp, K, Ldmax);
    return (int)cudaGetLastError();
}
