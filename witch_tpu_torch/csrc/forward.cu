// All-vs-all multihit Plan7 Forward scoring on Hopper: one warp (or a
// group of G warps, for wide models) per (model, query) pair, several
// pairs of one model in each CTA.
//
// Replaces: witch_tpu/ops/pallas_forward.py:_forward_kernel (the TPU
// kernel reached from pallas_forward_bits), which amortised the model
// tables over a tile of 128 queries on the vector unit.
//
// What bounds it on an H100: about 20 f32 operations per DP cell (model
// state x query row) and next to no device-memory traffic (a bank's
// tables are a few MB and stay in shared memory and L2), so the bound is
// the card's f32 rate outside the tensor cores: on the bench grid
// (20.25e9 cells at the models' own M) about 6 ms at 67 TFLOP/s. Before
// that, each cell reads 10 transition values from shared memory (40 B),
// so shared-memory bandwidth (~30 TB/s over 132 SMs) sets a floor near
// 45 ms there.
//
// Design:
// - A pair's row of Mpad = 32 G npl states is cut into contiguous chunks
//   of npl states, one per lane. With G = 1 (every width up to 1,536
//   states) a DP row needs no barrier at all: the delete chain's carry
//   across lanes is a warp scan of affine maps whose multipliers
//   (products of t_dd) are loop-invariant and computed once per pair,
//   and the E-state sum and the rescale max are warp shuffles. With
//   G > 1 the warps of one pair meet once per row at a named barrier of
//   the pair's own G*32 threads (never the whole block): every warp's
//   row is linear in the chain value entering it, so that one exchange
//   carries the chain, the E sum, the max and the outflow across the
//   warp boundary.
// - The row state stays in registers (npl is a template parameter):
//   M, I and the outflow u = M t_mm + I t_im + D t_dm; D itself is not
//   kept.
// - No separate rescale pass: each row is kept unscaled, and the next
//   row multiplies by 1/scale as it reads it.
// - The CTA's model transitions are copied into shared memory once per
//   CTA (layout 0), in a slot layout where a warp's 32 lanes read
//   32 consecutive floats; the emission rows use the same layout in
//   device memory (coalesced reads, L1/L2-resident).
// - The wrapper sorts the queries by length, longest first, so the pairs
//   of one CTA end together, and the kernel writes each score back at
//   its original [q, h].
// Layouts, chosen by width at launch (ops/forward.py:fwd_layout):
//   0  row in registers (npl > 0), transitions in shared memory: every
//      width whose transitions fit there (Mpad up to 6,400: bank widths
//      up to Mp 6,304; from 6,432 layout 1)
//   1  row in shared memory (npl = 0 here, run time), one pair of G = 8
//      warps per CTA, transitions in device memory: wider models, up to
//      the 16,384-state cap.
// Each query runs exactly its own length, so the scores need no padding
// correction; the plain version is ops/forward.py:forward_nats_ref.

#include "common.cuh"

#define FWD_THREADS 256
#define FWD_XS 8          // floats per warp in the per-row exchange

template <int NPL>
__global__ void __launch_bounds__(FWD_THREADS)
    fwd_kernel(const float *__restrict__ em_t, const float *__restrict__ tr_t,
               const int32_t *__restrict__ codes,
               const int32_t *__restrict__ qlens,
               const int32_t *__restrict__ order, float *__restrict__ out,
               int H, int Q, int K, int Lstride, int G, int npl_rt, int Mpad) {
    extern __shared__ float smem[];
    const int S = G * 32;                  // slot stride from j to j + 1
    const int WP = blockDim.x / S;         // pairs in this CTA
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int p = warp / G, g = warp - p * G;
    const int h = blockIdx.x % H;
    const int sq = (blockIdx.x / H) * WP + p;     // length-sorted query
    const int n = NPL ? NPL : npl_rt;
    float *sX = smem + (NPL ? 8 * Mpad : 0);      // [2][WP][G][FWD_XS]
    float *sW = sX + 2 * WP * G * FWD_XS;         // [WP][G][4] invariants
    float *sRow = sW + WP * G * 4;                // layout 1: [3][Mpad]
    const float *T = tr_t + (size_t)h * 8 * Mpad;
    if (NPL) {
        const float4 *src = reinterpret_cast<const float4 *>(T);
        float4 *dst = reinterpret_cast<float4 *>(smem);
        for (int t = threadIdx.x; t < 2 * Mpad; t += blockDim.x) dst[t] = src[t];
        __syncthreads();                    // once per CTA, not per row
        T = smem;
    }
    if (sq >= Q) return;                    // the pair's warps leave together
    const int q = order[sq];
    const int L = qlens[q];
    const int32_t *cq = codes + (size_t)q * Lstride;
    const float *tl = T + g * 32 + lane;
    const float *el = em_t + (size_t)h * K * Mpad + g * 32 + lane;
#define TR(r, j) tl[(r) * Mpad + (j) * S]

    LaneRow<NPL> row;
    row.bind(sRow + g * 32 + lane, Mpad, S);
    // Loop-invariant chain terms. Within the lane, D at its j-th state is
    // Dloc_j + P_j c, with c the chain value entering the lane and
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
    // warp scan of the lane maps: the multipliers of each step depend on
    // t_dd only, so they are taken once here
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
        // per warp: its map's multiplier, the E sum's and the last
        // state's D's sensitivity to the chain value entering the warp
        float se = ea * SP;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(FULL_MASK, se, o);
        const float aw = __shfl_sync(FULL_MASK, xa, 31);
        const float dl1 = __shfl_sync(FULL_MASK, ea * Plast, 31);
        if (lane == 0) {
            float *w = sW + (p * G + g) * 4;
            w[0] = aw;
            w[1] = se;
            w[2] = dl1;
        }
    }

    const float pmove = 3.0f / ((float)L + 3.0f);
    const float ploop = 1.0f - pmove;
    float N = 1.f, B = pmove, J = 0.f, C = 0.f, logs = 0.f, inv = 1.f;
    float uin = 0.f;        // outflow of the state left of the lane's chunk
    for (int i = 0; i < L; ++i) {
        const float *e = el + (size_t)cq[i] * Mpad;
        float b = 0.f, sM = 0.f, sD = 0.f, mx = 0.f, blast = 0.f, up = uin;
        // pass 1: M and I of row i from row i-1 (scaled on read), the
        // lane's chain with zero entering, and its sums
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
            float *x = sX + (((i & 1) * WP + p) * G + g) * FWD_XS;
            if (lane == 31) {
                x[0] = bi;
                x[1] = E;
                x[2] = mx;
                x[3] = row.M(n - 1);
                x[4] = row.I(n - 1);
                x[5] = blast + Plast * eb;
            }
            pair_barrier(1 + p, S);         // the one meeting of the row
            float D = 0.f, Et = 0.f, mt = 0.f;
            for (int gg = 0; gg < G; ++gg) {
                const float *xg = sX + (((i & 1) * WP + p) * G + gg) * FWD_XS;
                const float *wg = sW + (p * G + gg) * 4;
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
        const float Jn = J * ploop + E * 0.5f;
        const float Cn = C * ploop + E * 0.5f;
        const float Nn = N * ploop;
        const float Bn = Nn * pmove + Jn * pmove;
        const float scale = fmaxf(mx, fmaxf(Cn, fmaxf(Nn, SCALE_FLOOR)));
        const float iv = 1.0f / scale;
        N = Nn * iv;
        B = Bn * iv;
        J = Jn * iv;
        C = Cn * iv;
        logs = logs + logf(scale);
        // pass 2: D with its true entering value, and the outflow u
        float c = eb + ea * Din;
#pragma unroll
        for (int j = 0; j < (NPL ? NPL : n); ++j) {
            const float D = c;
            c = TR(T_DD, j) * c + TR(T_MD, j) * row.M(j);
            row.U(j) = row.M(j) * TR(T_MM, j) + row.I(j) * TR(T_IM, j) + D * TR(T_DM, j);
        }
        const float ul = __shfl_up_sync(FULL_MASK, row.U(n - 1), 1);
        uin = lane ? ul : uB;
        inv = iv;
    }
#undef TR
    if (g == 0 && lane == 0) out[(size_t)q * H + h] = logf(C * pmove) + logs;
}

template <int NPL>
static int launch(const float *em_t, const float *tr_t, const int32_t *codes,
                  const int32_t *qlens, const int32_t *order, float *out, int H,
                  int Q, int K, int Lstride, int G, int npl, int Mpad,
                  cudaStream_t stream) {
    const int WP = FWD_THREADS / (32 * G) > 0 ? FWD_THREADS / (32 * G) : 1;
    const int threads = WP * G * 32;
    if (threads > 1024) return (int)cudaErrorInvalidConfiguration;
    size_t floats = (size_t)2 * WP * G * FWD_XS + (size_t)WP * G * 4;
    floats += (size_t)(NPL ? 8 : 3) * Mpad;
    const size_t smem = floats * sizeof(float);
    cudaError_t err = set_smem((const void *)fwd_kernel<NPL>, smem);
    if (err != cudaSuccess) return (int)err;
    const size_t groups = ((size_t)Q + WP - 1) / WP;
    fwd_kernel<NPL><<<(unsigned)(groups * H), threads, smem, stream>>>(
        em_t, tr_t, codes, qlens, order, out, H, Q, K, Lstride, G, npl, Mpad);
    return (int)cudaGetLastError();
}

// layout 0: npl in {8, 16, 24, 32, 40, 48}; layout 1: any npl (rows in
// shared memory). Returns a cudaError_t code.
extern "C" int witch_forward_nats(const float *em_t, const float *tr_t,
                                  const int32_t *codes, const int32_t *qlens,
                                  const int32_t *order, float *out, int H, int Q,
                                  int K, int Lstride, int layout, int G, int npl,
                                  int Mpad, void *stream) {
    if (H <= 0 || Q <= 0) return 0;
    if (Mpad != 32 * G * npl) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define FWD_ARGS em_t, tr_t, codes, qlens, order, out, H, Q, K, Lstride, G, npl, Mpad, st
    if (layout == 0) {
        switch (npl) {
        case 8: return launch<8>(FWD_ARGS);
        case 16: return launch<16>(FWD_ARGS);
        case 24: return launch<24>(FWD_ARGS);
        case 32: return launch<32>(FWD_ARGS);
        case 40: return launch<40>(FWD_ARGS);
        case 48: return launch<48>(FWD_ARGS);
        default: return (int)cudaErrorInvalidValue;
        }
    }
    if (layout == 1) return launch<0>(FWD_ARGS);
#undef FWD_ARGS
    return (int)cudaErrorInvalidValue;
}
