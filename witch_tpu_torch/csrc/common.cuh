// Shared device helpers for the profile-HMM kernels. flank.cu and oa.cu's
// first version use the block-wide row helpers below; forward.cu, null2.cu
// and oa.cu's warp-per-pair kernel take only the constants, the lane-slot
// row (LaneRow), po2_scale, fresh_zero, pair_barrier and set_smem from
// here.
//
// The block-wide kernels run one CTA of NT threads per DP instance (a
// query-model pair or an envelope). The model-state axis k in [0, Mp) is
// cut into NT contiguous chunks, one per thread: thread t owns [k0, k1).
// A DP row lives in shared memory and is updated in place; each thread
// reads the one value left of its chunk (or right of it, for Backward)
// into a register before the barrier that precedes the update.
//
// The delete chains are first-order linear recurrences,
//   forward   D[k] = a[k] * D[k-1] + b[k]
//   backward  D[k] = a[k] * D[k+1] + b[k],
// computed over ALL k as a block scan of affine maps x -> a*x + b (the
// combine of witch_tpu/hmm/forward.py:_dchain_combine): each thread
// composes its chunk's maps, the block scans the per-thread maps, and a
// second pass over the chunk applies them. No pass is truncated.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define FULL_MASK 0xffffffffu

static constexpr float SCALE_FLOOR = 1e-30f;

struct Aff {
    float a, b;
};

// first f, then g
static __device__ __forceinline__ Aff aff_then(Aff f, Aff g) {
    return Aff{f.a * g.a, f.b * g.a + g.b};
}

static __device__ __forceinline__ void chunk_of(int Mp, int &k0, int &k1) {
    const int C = (Mp + NT - 1) / NT;
    k0 = min(Mp, (int)threadIdx.x * C);
    k1 = min(Mp, k0 + C);
}

// Value of the chain entering this thread's chunk (the composition of
// the maps of every logically earlier thread, applied to 0). `rev`
// orders threads from NT-1 down to 0 (backward chains). `sh` holds
// NWARP maps of scratch.
static __device__ float chain_enter(Aff m, bool rev, Aff *sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    Aff x = m;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const float pa = rev ? __shfl_down_sync(FULL_MASK, x.a, s)
                             : __shfl_up_sync(FULL_MASK, x.a, s);
        const float pb = rev ? __shfl_down_sync(FULL_MASK, x.b, s)
                             : __shfl_up_sync(FULL_MASK, x.b, s);
        const bool has = rev ? (lane + s < 32) : (lane >= s);
        if (has) x = aff_then(Aff{pa, pb}, x);
    }
    if (lane == (rev ? 0 : 31)) sh[w] = x;
    __syncthreads();
    float enter_w = 0.f;
    if (!rev) {
        for (int v = 0; v < w; ++v) enter_w = sh[v].a * enter_w + sh[v].b;
    } else {
        for (int v = NWARP - 1; v > w; --v)
            enter_w = sh[v].a * enter_w + sh[v].b;
    }
    const float pa = rev ? __shfl_down_sync(FULL_MASK, x.a, 1)
                         : __shfl_up_sync(FULL_MASK, x.a, 1);
    const float pb = rev ? __shfl_down_sync(FULL_MASK, x.b, 1)
                         : __shfl_up_sync(FULL_MASK, x.b, 1);
    const bool has1 = rev ? (lane < 31) : (lane > 0);
    const float enter = has1 ? pa * enter_w + pb : enter_w;
    __syncthreads();
    return enter;
}

struct OpSum {
    template <class T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct OpMax {
    template <class T> __device__ T operator()(T a, T b) const {
        return a > b ? a : b;
    }
};

// Block-wide reduction of one value; every thread gets the result, in
// a fixed order (deterministic). `sh` holds NWARP values of scratch.
template <class T, class Op>
static __device__ T block_reduce(T v, Op op, T *sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = op(v, __shfl_xor_sync(FULL_MASK, v, s));
    if (lane == 0) sh[w] = v;
    __syncthreads();
    T r = sh[0];
    for (int i = 1; i < NWARP; ++i) r = op(r, sh[i]);
    __syncthreads();
    return r;
}

// Two reductions at once (a sum and a max), one barrier pair.
static __device__ void block_sum_max(float &s, float &m, float *sh) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(FULL_MASK, s, o);
        m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
    }
    if (lane == 0) {
        sh[w] = s;
        sh[NWARP + w] = m;
    }
    __syncthreads();
    s = sh[0];
    m = sh[NWARP];
    for (int i = 1; i < NWARP; ++i) {
        s += sh[i];
        m = fmaxf(m, sh[NWARP + i]);
    }
    __syncthreads();
}

// Exact power-of-two row normalisation (witch_tpu/ops/pallas_oa.py:92):
// 2^floor(log2 s) as inverse and integer exponent.
static __device__ __forceinline__ void po2_scale(float scale, float &inv, float &kexp) {
    const int eb = __float_as_int(scale) & 0x7F800000;
    inv = __int_as_float((254 << 23) - eb);
    kexp = (float)((eb >> 23) - 127);
}

// Transition rows of one model: tr[r * Mp + k], r = mm mi md im ii dm dd bm
#define T_MM 0
#define T_MI 1
#define T_MD 2
#define T_IM 3
#define T_II 4
#define T_DM 5
#define T_DD 6
#define T_BM 7

// One Forward row of the core states, in place on the previous row
// (sM, sI, sD, all scaled): consumes emission row e[k] with begin mass
// Bv. Returns this thread's partial sum(M) + sum(D) and max(M).
static __device__ void forward_core_row(float *sM, float *sI, float *sD,
                                 const float *__restrict__ tr,
                                 const float *__restrict__ e, float Bv,
                                 int Mp, float &part_sum, float &part_max,
                                 Aff *shA) {
    int k0, k1;
    chunk_of(Mp, k0, k1);
    const float *tmm = tr + T_MM * Mp, *tmi = tr + T_MI * Mp,
                *tmd = tr + T_MD * Mp, *tim = tr + T_IM * Mp,
                *tii = tr + T_II * Mp, *tdm = tr + T_DM * Mp,
                *tdd = tr + T_DD * Mp, *bm = tr + T_BM * Mp;
    // the value left of the chunk, before anyone overwrites it
    float lM = 0.f, lI = 0.f, lD = 0.f;
    if (k0 < k1 && k0 >= 1) {
        lM = sM[k0 - 1];
        lI = sI[k0 - 1];
        lD = sD[k0 - 1];
    }
    __syncthreads();
    float psum = 0.f, pmax = 0.f;
    // descending, so sM[k-1] is still the previous row's value
    for (int k = k1 - 1; k >= k0; --k) {
        float src;
        if (k >= 1) {
            const float pM = (k == k0) ? lM : sM[k - 1];
            const float pI = (k == k0) ? lI : sI[k - 1];
            const float pD = (k == k0) ? lD : sD[k - 1];
            src = pM * tmm[k - 1] + pI * tim[k - 1] + pD * tdm[k - 1];
        } else {
            src = 0.f;
        }
        src = src + Bv * bm[k];
        const float Mrow = src * e[k];
        const float Irow = sM[k] * tmi[k] + sI[k] * tii[k];
        sM[k] = Mrow;
        sI[k] = Irow;
        psum += Mrow;
        pmax = fmaxf(pmax, Mrow);
    }
    __syncthreads();
    // delete chain: D[k] = tdd[k-1] D[k-1] + tmd[k-1] M[k-1], D[0] = 0
    Aff m{1.f, 0.f};
    for (int k = k0; k < k1; ++k) {
        const Aff f = (k >= 1) ? Aff{tdd[k - 1], tmd[k - 1] * sM[k - 1]}
                               : Aff{0.f, 0.f};
        m = aff_then(m, f);
    }
    float d = chain_enter(m, false, shA);
    for (int k = k0; k < k1; ++k) {
        d = (k >= 1) ? tdd[k - 1] * d + tmd[k - 1] * sM[k - 1] : 0.f;
        sD[k] = d;
        psum += d;
    }
    part_sum = psum;
    part_max = pmax;
}

// One unihit Backward row of the core states, in place on the next row
// (bM, bI; sD is scratch): row i from row i+1, consuming the emission
// row e of residue i+1. bE is the E-state value of row i. Returns this
// thread's partial sum_k bm[k] * bM[k] * e[k] (the B-state value) and
// max(bM new).
static __device__ void backward_core_row(float *bM, float *bI, float *sD,
                                  const float *__restrict__ tr,
                                  const float *__restrict__ e, float bE,
                                  int Mp, float &part_B, float &part_max,
                                  Aff *shA) {
    int k0, k1;
    chunk_of(Mp, k0, k1);
    const float *tmm = tr + T_MM * Mp, *tmi = tr + T_MI * Mp,
                *tmd = tr + T_MD * Mp, *tim = tr + T_IM * Mp,
                *tii = tr + T_II * Mp, *tdm = tr + T_DM * Mp,
                *tdd = tr + T_DD * Mp, *bm = tr + T_BM * Mp;
    // mne right of the chunk, before anyone overwrites it
    float rmne = 0.f;
    if (k0 < k1 && k1 < Mp) rmne = bM[k1] * e[k1];
    __syncthreads();
    // chain maps, high k to low: D[k] = tdd[k] D[k+1] + c[k]
    float pB = 0.f;
    Aff m{1.f, 0.f};
    for (int k = k1 - 1; k >= k0; --k) {
        const float mne_k1 = (k == k1 - 1) ? rmne : bM[k + 1] * e[k + 1];
        const float c = mne_k1 * tdm[k] + bE;
        m = aff_then(m, Aff{tdd[k], c});
        pB += bm[k] * (bM[k] * e[k]);
    }
    float dn = chain_enter(m, true, shA);   // D[k1]
    for (int k = k1 - 1; k >= k0; --k) {
        const float mne_k1 = (k == k1 - 1) ? rmne : bM[k + 1] * e[k + 1];
        const float c = mne_k1 * tdm[k] + bE;
        const float dk = tdd[k] * dn + c;
        sD[k] = dn;   // D[k+1], consumed by the ascending pass below
        dn = dk;
    }
    // ascending, so bM[k+1] is still the next row's value
    float pmax = 0.f;
    for (int k = k0; k < k1; ++k) {
        const float mne_k1 = (k == k1 - 1) ? rmne : bM[k + 1] * e[k + 1];
        const float Dk1 = sD[k];
        const float In = bI[k];
        const float Mi = bE + mne_k1 * tmm[k] + In * tmi[k] + Dk1 * tmd[k];
        const float Ii = mne_k1 * tim[k] + In * tii[k];
        bM[k] = Mi;
        bI[k] = Ii;
        pmax = fmaxf(pmax, Mi);
    }
    part_B = pB;
    part_max = pmax;
}

// Terminal Backward row (row L): bE = move, bI = 0,
// bM[k] = bE + tmd[k] D[k+1] with D[k] = bE + tdd[k] D[k+1].
static __device__ void backward_terminal_row(float *bM, float *bI, float *sD,
                                      const float *__restrict__ tr,
                                      float bE, int Mp, Aff *shA) {
    int k0, k1;
    chunk_of(Mp, k0, k1);
    const float *tmd = tr + T_MD * Mp, *tdd = tr + T_DD * Mp;
    __syncthreads();
    Aff m{1.f, 0.f};
    for (int k = k1 - 1; k >= k0; --k) m = aff_then(m, Aff{tdd[k], bE});
    float dn = chain_enter(m, true, shA);
    for (int k = k1 - 1; k >= k0; --k) {
        bM[k] = bE + dn * tmd[k];
        bI[k] = 0.f;
        dn = tdd[k] * dn + bE;
    }
    (void)sD;
}

static __device__ __forceinline__ void scale_rows(float *a, float *b, float *c,
                                           float inv, int Mp) {
    int k0, k1;
    chunk_of(Mp, k0, k1);
    for (int k = k0; k < k1; ++k) {
        a[k] *= inv;
        b[k] *= inv;
        if (c) c[k] *= inv;
    }
}

// Lane-slot layout of the warp-per-instance kernels (forward.cu,
// null2.cu; oa.cu keeps its rows in k order and takes only LaneRow's
// registers): an instance's row of Mpad = 32 G npl states is cut into
// contiguous chunks of npl states, one per lane of its G warps; state
// k = (g*32 + lane)*npl + j lives at slot (j*G + g)*32 + lane, so a warp's
// access to its j-th states touches 32 consecutive floats. LaneRow holds
// three such rows, in registers (NPL > 0) or in shared memory (NPL = 0,
// npl at run time).

template <int NPL> struct LaneRow {      // registers
    float m[NPL], i[NPL], u[NPL];
    __device__ __forceinline__ void bind(float *, int, int) {}
    __device__ __forceinline__ float &M(int j) { return m[j]; }
    __device__ __forceinline__ float &I(int j) { return i[j]; }
    __device__ __forceinline__ float &U(int j) { return u[j]; }
};

template <> struct LaneRow<0> {          // shared memory, runtime npl
    float *m, *i, *u;
    int S;
    __device__ __forceinline__ void bind(float *base, int Mpad, int S_) {
        m = base;
        i = base + Mpad;
        u = base + 2 * Mpad;
        S = S_;
    }
    __device__ __forceinline__ float &M(int j) { return m[j * S]; }
    __device__ __forceinline__ float &I(int j) { return i[j * S]; }
    __device__ __forceinline__ float &U(int j) { return u[j * S]; }
};

// A zero the compiler cannot see through, taken once per row and added to
// every transition index (null2.cu, oa.cu): a row's transition reads then
// go to shared memory instead of being held in registers across rows
// (held, null2's took 243 registers at 16 states per lane, one CTA per
// SM; re-read, 128).
static __device__ __forceinline__ int fresh_zero() {
    int z;
    asm volatile("mov.u32 %0, 0;" : "=r"(z));
    return z;
}

static __device__ __forceinline__ void pair_barrier(int id, int nthreads) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

static inline cudaError_t set_smem(const void *fn, size_t bytes) {
    if (bytes > 48 * 1024)
        return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)bytes);
    return cudaSuccess;
}
