// The ensemble's entropy weighting on Hopper: hmm/build.py:entropy_weight's
// bisection for every model of an ensemble in one launch.
//
// Replaces no TPU kernel: the JAX package builds its models on host NumPy
// (witch_tpu/hmm/build.py). This kernel was added because the bisection
// held about 60% of the ensemble build, a third of a dna1k job, while the
// card sat idle (ops/effn.py; the rest of the build stays on the host).
//
// One CTA a model. Each bisection step evaluates the mean match relative
// entropy of the model's emission counts scaled by neff / nseq: every
// thread takes columns THREADS apart, computes the mixture-Dirichlet
// posterior mean of each (hmm/priors.py:MixtureDirichlet.posterior_mean:
// NC components, K residues) and its relative-entropy terms
// p (log2 p - log2 bg), and a block reduction gives the sum. Every thread
// then takes the same branch. The steps are entropy_weight's, in its
// order: the test at full counts (f <= 0 returns nseq), then midpoints of
// [0, nseq] until f == 0 or hi - lo < 0.01, at most MAX_ITER of them.
//
// Exactness. A step's f here differs from NumPy's in the last bits (CUDA's
// lgamma, exp and log2, another summation order), but the result depends
// only on the signs of the f's: each midpoint is an exact function of the
// branches taken. So the kernel writes, beside each effn, the smallest |f|
// of its steps (NaN if any f was NaN), and ops/effn.py redoes on the host
// every model below EFFN_GUARD: each effn it keeps equals the host's bit
// for bit.
//
// What bounds it: f64 operations. A DNA column-step (one column's terms
// at one bisection step) is ~1,460 of them: 20 lgamma at ~40 each, 4 exp,
// 4 log2, 32 divisions and 160 others (chip_smoke.py:EFFN_COSTS). A dna1k
// job's 285 models (383,878 columns, 3,619 steps) make 4,875,015
// column-steps, ~7.1 GFLOP, 0.21 ms at the H100's 34 TFLOP/s f64 rate.
// The counts (12 MB) are read once a step, from L2 after the first. The
// chain of up to 19 dependent steps a model, each ending in a block
// barrier, and the longest model (up to ~6 columns a thread) set the
// launch's time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ITER = 100;   // entropy_weight's max_iter

template <int K, int NC>
struct Prior {
    double a[NC][K];      // component pseudocounts
    double lga[NC][K];    // lgamma(a)
    double asum[NC];
    double cst[NC];       // log(q) + lgamma(asum)
    double l2bg[K];       // log2 of the background
};

// Relative-entropy terms of one column's posterior mean, its counts
// scaled by `scale` (posterior_mean, then mean_match_relative_entropy's
// terms; a zero p gives 0 there through nan_to_num).
template <int K, int NC>
__device__ double column_terms(const double *__restrict__ cnt, double scale,
                               const Prior<K, NC> &pr) {
    double c[K];
    double n = 0.0;
#pragma unroll
    for (int d = 0; d < K; ++d) {
        c[d] = cnt[d] * scale;
        n += c[d];
    }
    double w[NC];
    double mx = -INFINITY;
    // the amino prior's 180 lgamma a column stay a loop (code size)
#pragma unroll(NC <= 4 ? NC : 1)
    for (int k = 0; k < NC; ++k) {
        double s = 0.0;
#pragma unroll
        for (int d = 0; d < K; ++d) s += lgamma(c[d] + pr.a[k][d]) - pr.lga[k][d];
        w[k] = (pr.cst[k] - lgamma(n + pr.asum[k])) + s;
        mx = fmax(mx, w[k]);
    }
    double ws = 0.0;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
        w[k] = exp(w[k] - mx);
        ws += w[k];
    }
    double t = 0.0;
#pragma unroll
    for (int d = 0; d < K; ++d) {
        double p = 0.0;
#pragma unroll
        for (int k = 0; k < NC; ++k)
            p += (w[k] / ws) * ((c[d] + pr.a[k][d]) / (n + pr.asum[k]));
        if (p > 0.0) t += p * (log2(p) - pr.l2bg[d]);
    }
    return t;
}

// The block's sum of v; every thread gets it.
__device__ double block_sum(double v, double *red, double *tot) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int w = 0; w < THREADS / 32; ++w) s += red[w];
        *tot = s;
    }
    __syncthreads();
    // red and tot are written again only after the next step's first
    // barrier, which every thread reaches after reading tot here
    return *tot;
}

template <int K, int NC>
__global__ void __launch_bounds__(THREADS)
effn_kernel(const double *__restrict__ counts, const int64_t *__restrict__ off,
            const double *__restrict__ nseq, const double *__restrict__ etarget,
            const double *__restrict__ prior, const double *__restrict__ bg,
            double *__restrict__ effn, double *__restrict__ minf) {
    __shared__ Prior<K, NC> pr;
    __shared__ double red[THREADS / 32];
    __shared__ double tot;
    const int tid = threadIdx.x;
    for (int i = tid; i < NC * K; i += THREADS) {
        const int k = i / K, d = i % K;
        const double a = prior[k * (K + 1) + 1 + d];
        pr.a[k][d] = a;
        pr.lga[k][d] = lgamma(a);
    }
    if (tid < K) pr.l2bg[tid] = log2(bg[tid]);
    __syncthreads();
    if (tid < NC) {
        double s = 0.0;
        for (int d = 0; d < K; ++d) s += pr.a[tid][d];
        pr.asum[tid] = s;
        pr.cst[tid] = log(prior[tid * (K + 1)]) + lgamma(s);
    }
    __syncthreads();

    const int m = blockIdx.x;
    const int64_t c0 = off[m];
    const int M = (int)(off[m + 1] - c0);
    const double n = nseq[m], target = etarget[m];
    const double *cm = counts + c0 * K;
    double mn = INFINITY;   // smallest |f|; NaN once any f is NaN
    auto f_at = [&](double neff) {
        const double scale = neff / n;
        double acc = 0.0;
        for (int col = tid; col < M; col += THREADS)
            acc += column_terms<K, NC>(cm + (int64_t)col * K, scale, pr);
        const double f = block_sum(acc, red, &tot) / (double)M - target;
        const double a = fabs(f);
        mn = (isnan(a) || isnan(mn)) ? NAN : fmin(mn, a);
        return f;
    };

    double out;
    if (f_at(n) <= 0.0) {
        out = n;
    } else {
        double lo = 0.0, hi = n;
        out = NAN;
        for (int it = 0; it < MAX_ITER; ++it) {
            const double mid = 0.5 * (lo + hi);
            const double f = f_at(mid);
            if (f == 0.0 || (hi - lo) < 0.01) {
                out = mid;
                break;
            }
            if (f > 0.0) hi = mid;
            else lo = mid;
        }
        if (isnan(out)) out = 0.5 * (lo + hi);
    }
    if (tid == 0) {
        effn[m] = out;
        minf[m] = mn;
    }
}

}  // namespace

// One CTA a model: counts [sum M][K] f64 (the models' match rows back to
// back, model i's from row off[i]), off [n + 1], nseq, etarget [n], prior
// [NC][K + 1] (q, then the component's alphas), bg [K]; writes effn and
// minf [n]. K and NC: 4, 4 (DNA, RNA) or 20, 9 (amino).
extern "C" int witch_effn(const double *counts, const int64_t *off,
                          const double *nseq, const double *etarget,
                          const double *prior, const double *bg, double *effn,
                          double *minf, int n, int K, int NC, void *stream) {
    if (n <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (K == 4 && NC == 4)
        effn_kernel<4, 4><<<n, THREADS, 0, st>>>(counts, off, nseq, etarget,
                                                 prior, bg, effn, minf);
    else if (K == 20 && NC == 9)
        effn_kernel<20, 9><<<n, THREADS, 0, st>>>(counts, off, nseq, etarget,
                                                  prior, bg, effn, minf);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
