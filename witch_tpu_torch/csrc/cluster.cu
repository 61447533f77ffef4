// Probe of the thread-block cluster meeting that oa.cu's and flank.cu's
// cluster instances cross several times a DP row: the cluster barrier
// alone (mode 0), and a DSMEM exchange of one record (mode 1: every warp
// of the cluster pushes an 8-float record into every CTA's shared memory,
// the cluster crosses the barrier, and every thread reads all the
// records back from its own CTA, as a meeting's loop does). One cluster
// measures the round trip's latency; as many clusters as the card holds
// at once measure it under load. Used by ops/cluster.py (tools and
// chip_smoke.py); not a kernel of any path.

#include "cluster.cuh"
#include "common.cuh"

#define PROBE_REC 8

__global__ void __launch_bounds__(NT)
    cluster_probe_kernel(int C, int reps, int mode, float *__restrict__ sink,
                         long long *__restrict__ cycles) {
    extern __shared__ float smem[];         // [2][8 C][PROBE_REC]
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rank = cluster_rank();
    const int G = NWARP * C, g = rank * NWARP + warp;
    cluster_meet();                         // every CTA of the cluster started
    float acc = 0.f;
    const long long t0 = clock64();
    for (int r = 0; r < reps; ++r) {
        float *buf = smem + (r & 1) * G * PROBE_REC;
        if (mode) {
#pragma unroll
            for (int t = 0; t < PROBE_REC; ++t)
                put_all_uniform(buf + g * PROBE_REC + t, acc + (float)(t + r), C);
        }
        cluster_meet();
        if (mode) {
            float s = 0.f;
            for (int gg = 0; gg < G; ++gg) s += buf[gg * PROBE_REC + (lane & 7)];
            acc += s * 1e-30f;
        }
    }
    const long long t1 = clock64();
    if (threadIdx.x == 0 && rank == 0) cycles[blockIdx.x / C] = (t1 - t0) / (reps > 0 ? reps : 1);
    if (acc == 12345.f) sink[0] = acc;      // keeps the reads
    cluster_meet();                         // no CTA leaves while others write to it
}

static size_t probe_smem(int C) { return (size_t)2 * NWARP * C * PROBE_REC * sizeof(float); }

// nclusters clusters of C CTAs of 256 threads, reps meetings each;
// cycles[c] gets cluster c's SM cycles per meeting. Returns a cudaError_t
// code (refused when no such cluster can be resident).
extern "C" int witch_cluster_probe(int C, int reps, int mode, int nclusters, float *sink,
                                   long long *cycles, void *stream) {
    if (C < 1 || C > 8) return (int)cudaErrorInvalidValue;
    return (int)launch_cluster(cluster_probe_kernel, nclusters, C, NT, probe_smem(C),
                               (cudaStream_t)stream, C, reps, mode, sink, cycles);
}

// Clusters of the probe's shape the card holds at once, or -error.
extern "C" int witch_cluster_probe_active(int C) {
    return max_active_clusters(cluster_probe_kernel, C, NT, probe_smem(C));
}
