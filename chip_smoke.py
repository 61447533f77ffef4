"""On-card smoke test of the PyTorch/CUDA port (witch_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card, exits 0 on success

Phases:
  1. card name and power limit, the host's os.cpu_count(); nvcc build of
     the five CUDA kernels (one nvcc per source, in parallel) and the
     native host engine's build, each timed;
  2. each kernel against its plain PyTorch version on the card at
     main-path shapes, and against the native f64 engine:
       forward  bench_assets.npz grid (141 models x 500 queries, Mp 1,312
                and 2,720), |dbits| <= 1e-3 vs plain; 2,000 sampled pairs
                vs native, <= 1e-3; (2f) the amino500 main path's own
                inputs (Mp 416) and (4d) dna1k's (the kernel's ms at
                those shapes; 100 queries against plain), <= 1e-3; the
                wide widths in 2e
       flank    (2d) the same grid (both banks on the warp-per-pair
                kernel): fwd within 5e-3 nats and ppB, ppE, mocc within
                2e-3 of plain; three-way gate decisions equal except for
                pairs whose rows sit within 1e-3 of RT1, RT2 or RT3; the
                layout of each width and the bound of its outputs and
                stored specials
       null2    the envelopes of the amino500 gate: envsc, useI, usetot,
                n2dot within 1e-4 relative (|d| / max(|ref|, 1e-2));
                assembled sbias/senv within 2e-3 bits and sbsum 5e-3 of
                native evaluate_targets_rows, gate integers exact
       oa       the amino500 alignment pairs + 256 bench_assets pairs
                (Mp 416, 1,312 and 2,720: the warp-per-pair kernel):
                identical columns on every pair with margin >= 2e-3, vs
                plain and vs native posterior_oa_pair, finite margins
                within 1e-4 of plain; (4e) dna1k's pairs (Mp 1,440 and
                1,568): ms, launches and bounds over all of them, and a
                seeded sample (the 64 longest, 64 at random) held so;
       wide     (2e) a bank of a 8,000-state and a 16,384-state model
                (Mp 8,096 and 16,416: OA's and flank's cluster instances,
                null2 rows in device memory, forward's second layout):
                all four kernels with the tolerances above, vs plain and
                native, and OA's and flank's first versions' ms on the
                same calls; (2h) the thread-block cluster meeting
                (ops/cluster.py: ns of the barrier alone and of a DSMEM
                exchange of one record at C = 2, 4 and 8, one cluster and
                every co-resident one) and the clusters of each OA and
                flank cluster shape the card holds at once;
       bench    (2g) witch_tpu_torch/tools/bench.py in process: bench.py's
                JSON line (the full grid through the forward kernel, the
                native domain definition rate), its seconds_per_full_grid
                beside 2a's kernel ms;
  3. amino500 golden end to end through witch_tpu_torch.witch_runner:
     600/600 masked rows equal the oracle; all three kernels launched;
     the align stage joined the speculative OA start; before it the same
     with WITCH_TPU_SPEC_OA=0 (600/600, no speculative join); (3d) a
     resident server (python -m witch_tpu_torch serve) answers amino500
     twice with outputs byte-identical to phase 3's, the three kernels
     launched in it, and a bench job with bench_tier's keys, each job's
     seconds beside phase 3's wall and a fresh CLI process's, the server
     killed at the end; (3b) amino500 with --full-search-results 1
     (600/600 rows, the flank kernel launched, full_search_replay below)
     and (3c) with -m old-witch (every query placed with its residues or
     ignored, 0 above-guard OA mismatches against native over all its
     pairs, the query rows against the JAX package's,
     tests/golden/ref_amino500_ow.*, at least AMINO500_OW_JAX);
  4. seeded DNA scenario D, 1,000 backbone + 1,000 queries
     (scripts/make_scale_dataset.py), through the CLI: every query placed
     or ignored, backbone rows intact, 200 sampled OA pairs equal native
     above the guard, forward, null2, oa, overlay and effn launched, the
     gate line (null2's
     device time, kernel ms and launches), the speculative join and its
     selection-drift count; the query rows against the JAX
     package's (tests/golden/ref_dna1k.queries.masked.fasta.gz): the count
     equal, at least DNA1K_JAX_MIN, and for a differing row the device
     and native pre-score rankings of its top models; (4o) the print
     overlay's split chain (ops/overlay.py, csrc/overlay.cu) on 4's band
     pairs, through the pipeline's routing and through the card launcher
     alone: ok, seq and pre bit-identical to exact_scores32, 2 launches,
     the card deciding 95% of the pairs or more, each launch's kernel ms
     beside its serial-chain bound, and the native engine's wall on the
     same pairs, then a model one stripe too wide falling back, counted;
     the overlay's entry in the kernels line; (4h) the entropy-weighting
     kernel (ops/effn.py, csrc/effn.cu) on the counts of 4's ensemble
     (285 models): one launch, every effn bit for bit the plain
     version's on the same card tensors and the host's entropy_weight,
     the smallest margins within EFFN_MINF_TOL of the plain version's and
     none below the guard, the kernel's ms beside the plain version's,
     the host bisection's and its f64 bound from the run's column-steps;
     its entry in the kernels line; after
     4d and 4e (item 2), (4m) the data mesh
     (witch_tpu_torch/parallel/mesh.py) over every visible card, on a
     one-card host over cuda:0 twice (said on its own line): dna1k's two
     banks on 4's inputs, np.array_equal to 4's single-card bits, each
     card's kernel ms, then amino500 end to end with the mesh (every
     other phase runs with WITCH_TPU_NO_MESH=1): 600/600, the mesh
     logged, one forward launch a bank a card, outputs byte-identical to
     phase 3's; then (4c) the same
     backbone with --full-search-results 1 on its first 30 queries, a
     grid the prefilter drops pairs of: every query placed or ignored,
     and full_search_replay (the path's flank inputs through kernel and
     plain with the 2d bounds and decisions, every width on the
     warp-per-pair kernel, its ms and bounds, the copied rows, 500
     sampled dropped pairs unreported by native evaluate_targets, 300
     sampled kept pairs equal between native domain definition on the
     device rows and on its own f64 rows); then (4b) scenario C on the
     same backbone and its first DNA1K_C_Q = 300 queries (-e left out):
     the device distance counts equal numpy
     float64, every query placed or ignored, backbone rows intact, the
     query rows against the JAX package's (ref_dna1k_c.*, at least
     DNA1K_C_JAX); (4s) query sharding: dna1k (4's data) through
     witch_tpu_torch/tools/run_distributed.py as two gloo ranks at once on
     the one card, into one outdir: exactly one rank merged, the merged
     aligned.masked.fasta byte-identical to 4's, the query rows against
     the JAX package's (at least DNA1K_JAX_MIN), forward, null2 and oa
     launched by each rank, each rank's wall and gather time beside 4's
     wall; then amino500 as WITCH_TPU_SHARD 0/2 and 1/2 started at the
     same moment into one outdir (the file-staged gather): exactly one
     merged, 600/600 rows equal the oracle and phase 3's bytes;
     (4w) dnawide: scenario D on a 7,110-column DNA backbone
     (make_scale_dataset.py --n 200 --queries 100 --cols 8000 --seed
     20261017), its first DNAWIDE_Q queries: every query placed or
     ignored, backbone rows intact, each bank's Mp and each kernel's
     layout (OA on its cluster instance at every alignment bank), the
     query rows against the JAX package's (ref_dnawide.*, at least
     DNAWIDE_JAX; a differing row's pre-score rankings); (4wd, 4wn) the
     forward and null2 kernels on its inputs (ms, bounds, vs plain on a
     few); (4wo) all its OA pairs through the cluster kernel and the
     first version on the same calls (ms, launches, bounds; the kernel
     faster, the same flags and columns above the guard), a seeded
     sample (16 longest, 16 at random) vs plain and native; (4wc) its
     first DNAWIDE_FULL queries with --full-search-results 1:
     full_search_replay with 2d's tolerances on the flank cluster
     instance, the first version's ms on the same calls;
     (4g) the reference WITCH's DNA example against its oracle (all
     1,000 masked rows), where tests/test_golden.py finds its data, or a
     line saying the data is absent;
  5. scenario A: -i of 300 ungapped full-length rows and 100 fragments
     (make_scale_dataset.py) with --backbone-size 100: every input
     sequence in the output with its residues (or ignored), masked rows
     flush, the gate line, every masked row against the JAX package's
     (ref_scenA.*, at least SCEN_A_JAX); (5b) its gate envelopes
     replayed through the null2 kernel (ms, launches, bound) and, on
     1,024 seeded envelopes, its plain version within 1e-4 relative;
     (5c) nvcc -Xptxas -v of csrc/pairhmm.cu, no instance spilling; the
     anchor embedding of its 100 backbone sequences on the device path
     (2,400 sequence-anchor pairs) through the pair-HMM kernel and its
     plain version, E within 2e-4, the register kernel at every width,
     the kernel's ms beside the first version's on the same calls,
     plain's and the bound; then dna1k's data at the default
     1,000-sequence backbone (24,000 pairs): the kernel's ms, launches,
     cells and bound, the first version's ms, plain on its one launch,
     within 2e-4 a residue; (5w) dnawide's backbone embedding (phase
     4w's data, 100 sequences of ~7,000 residues, 2,400 pairs) on the
     wide layout (one CTA of G warps a pair): no wide instance spilling,
     the wide layout at every width with its CTAs a SM, its ms below the
     first version's on the same calls, the bound, 256 seeded pairs
     against plain within 2e-4 a residue; (5d) scenario A again with
     WITCH_TPU_DEVICE_EMBED=1: phase 5's checks, the rows against the
     same golden, and the pair-HMM kernel launched, the register kernel
     at every width; (5e) scenario A on long sequences (make_scale_
     dataset.py --n 120 --queries 30 --cols 1920 --seed 20261018,
     --backbone-size 70) with WITCH_TPU_DEVICE_EMBED=1: phase 5's checks,
     every masked row against the JAX package's (ref_scenA_long.*, at
     least SCEN_A_LONG_JAX), the pair-HMM kernel launched on the wide
     layout at every call, and the path's 1,680 embedding pairs replayed
     (the wide layout's ms, the first version's on the same calls,
     plain's within 2e-4 a residue, the bound);
  6. {"kernels": [...]} JSON (each kernel's launches on the main path
     and on every other path, the mesh's of 4m(b) among them, error, ms
     and plain ms, and its bound: the larger of its operations at 67
     TFLOP/s, the H100's f32 rate outside the tensor cores, OA's DP at 34
     TFLOP/s, its f64 rate, and its bytes, inputs read once and outputs
     written once, at 3.35 TB/s; forward's entry also 4m(a)'s cards and
     each card's kernel ms; OA's entry also the dna1k
     replay's and its stored rows' bound, 17 B per state-row; flank's the
     full-search replays', the bound of its outputs and stored specials,
     rows_bytes_ms, and its layout at each width; pairhmm's main path is
     scenario A with WITCH_TPU_DEVICE_EMBED=1, its entry also the first
     version's ms, the layout (layout, CH, G) at each width, each
     instance's registers, spills and warps a SM, and the 24,000-pair,
     dnawide (5w) and scenario_a_long (5e) runs' numbers), the
     nvidia-smi line, a check that no module of JAX or witch_tpu was
     loaded, and as the last line {"ok": true, "device": {...}}.

Any failed check raises; the script then exits nonzero without the
result line. Imports nothing of JAX and nothing of witch_tpu: the host
stages are the port's own modules, and its native engine is built from
witch_tpu_torch/native/.
"""

import copy
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None          # the port must not reach JAX
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

GOLD = os.path.join(ROOT, "tests", "golden")
OA_GUARD = 2e-3
# sizes of the phases (a cut of scale is listed in PERF.md)
AMINO = ("ref_amino500", 600)       # golden prefix, masked rows
DNA_N = 1000                        # dna1k backbone and queries
WIDE_M = (8000, 16384)              # phase 2e model sizes
DNA_FULL = 30                       # dna1k queries of the full search (cut
                                    # from 60 for the smoke budget)
DNA1K_C_Q = 300                     # dna1k queries of scenario C (4b;
                                    # cut from 1,000 for the smoke budget:
                                    # a query's row depends on it alone)
# dnawide (4w): make_scale_dataset.py --n 200 --queries 100 --cols 8000
# --seed 20261017, 7,110 columns; the queries run in 4w (cut from 100:
# the host's exact-f32 overlay took 93.6 s of the 134.5 s wall at 100,
# 49.4 s of 74.2 s at 40) and in its full search (4wc; cut from 10, whose
# native domain definition of 493 kept pairs took 67.8 s of 117.9 s)
DNAWIDE = (200, 100, 8000, 20261017)
DNAWIDE_Q = 30
DNAWIDE_FULL = 4
SCEN_A = (300, 100, 100)            # full-length, fragments, backbone
# scenario A on long sequences (5e): make_scale_dataset.py --n 120
# --queries 30 --cols 1920 --seed 20261018 (full-length rows of 1,647-
# 1,686 residues), --backbone-size 70: its anchor embedding takes the
# pair-HMM kernel's wide layout
SCEN_A_LONG = (120, 30, 1920, 20261018, 70)
# dnawide's backbone embedding (5w): the sequences select_backbone picks
# of phase 4w's data (~7,000 residues, 2,400 pairs), and the seeded pairs
# compared with plain
DNAWIDE_EMBED = 100
DNAWIDE_EMBED_PLAIN = 256
REC_ALIGNER = []        # the DeviceAligner of the latest CLI run
WALL = {}               # CLI wall seconds by run label
# dna1k against the JAX package (tests/golden/ref_dna1k.queries.masked.
# fasta.gz): the query rows equal on the first chip run (PERF.md), below
# which the check fails; the JAX run ignored no query; rows diagnosed
DNA1K_JAX_MIN = 1000
JAX_DNA1K_IGNORED = ()
DNA1K_DIAG = 20
# dnawide against the JAX package (tests/golden/ref_dnawide.queries.
# masked.fasta.gz): the query rows equal on the first chip run, below
# which the check fails
DNAWIDE_JAX = ("ref_dnawide.queries.masked.fasta.gz", 30)
# the JAX package's rows of three more paths (tests/golden/, made on the
# CPU with JAX_PLATFORMS=cpu python -m witch_tpu, commands in PERF.md):
# golden file and the rows equal on the first chip run, below which the
# check fails. Scenario A: every masked row (phases 5 and 5d, with and
# without the device embedding: its rows are the same; 5e on the long
# input); dna1k scenario C (4b; its first DNA1K_C_Q queries, all equal
# at 1,000 too) and amino500 -m old-witch (3c): the query rows
SCEN_A_JAX = ("ref_scenA.aligned.masked.fasta.gz", 400)
SCEN_A_LONG_JAX = ("ref_scenA_long.aligned.masked.fasta.gz", 150)
DNA1K_C_JAX = ("ref_dna1k_c.queries.masked.fasta.gz", 300)
AMINO500_OW_JAX = ("ref_amino500_ow.queries.masked.fasta.gz", 500)
JAX_DIFF_SHOWN = 10
# the pair-HMM embedding at dna1k's data and the default 1,000-sequence
# backbone (5c): 24,000 sequence-anchor pairs
DNA1K_BACKBONE = 1000
# bounds: H100 SXM f32 rate outside the tensor cores, f64 rate and HBM
# rate (the card's published peaks); operations per DP cell (model
# state x residue, at the models' own M), read off the plain versions:
# forward 20 (src 7, M 1, I 3, delete chain 3, E sum 2, max 1, rescale
# 3), flank 40 (that Forward and a Backward of the same count), null2 45
# (Forward, Backward, 5 for the posterior state usage), oa 58 (Forward
# and Backward 40 and the posteriors 4 at the f32 rate, the OA DP's 14 at
# the f64 rate), pairhmm 17 per cell of A x B, from the recurrence
# alone (the previous row's three values rescaled 3, M 5 with t_gm
# factored out, X 3, Y 3, the row max 3; the kernel's own scan of the
# chunks' affine maps is not counted)
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
HBM_BYTES_PER_S = 3.35e12
# H100 SXM's boost SM clock and the latency of one dependent f32 multiply
# or add (the overlay kernel's serial-chain bound, phase 4o)
SM_CLOCK_HZ = 1.98e9
FP32_DEP_CYCLES = 4
OPS_PER_CELL = {"forward": 20, "flank": 40, "null2": 45, "oa": 58,
                "pairhmm": 17}
F64_OPS_PER_CELL = {"oa": 14}
# The entropy-weighting kernel (phase 4h) is bound by f64 operations a
# column a bisection step, counted from csrc/effn.cu's column_terms with
# each libm call at a fixed cost: CUDA's f64 lgamma ~40 (a polynomial or
# Stirling series and a log), exp ~20, log2 ~25, a division ~10 (a
# reciprocal and its Newton steps). DNA (K 4, NC 4): 20 lgamma, 4 exp,
# 4 log2, 32 divisions and 160 others, 1,460 a column-step.
EFFN_COSTS = {"lgamma": 40, "exp": 20, "log2": 25, "div": 10}
# the largest difference, in bits, allowed between the kernel's smallest
# |f| of a model and the plain version's on the same card tensors (both
# f64, another summation order)
EFFN_MINF_TOL = 1e-11
# bytes of stored scratch per state-row, at the kernel's padded width:
# null2 16 (Forward M and I written and read back), oa 17 (Backward bM and
# bI written and read back, the pointer byte written)
ROW_BYTES = {"null2": 16, "oa": 17}


def say(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    say("  PASS", what)


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        "nvidia-smi unavailable"


def bound_ms(name, cells, nbytes):
    """(least ms for the work, "operations" or "bytes")."""
    f64 = F64_OPS_PER_CELL.get(name, 0)
    t_ops = ((OPS_PER_CELL[name] - f64) / F32_OPS_PER_S
             + f64 / F64_OPS_PER_S) * cells * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def effn_ops_per_column(K, NC):
    """f64 operations of one column's relative-entropy terms (EFFN_COSTS):
    NC (K + 1) lgamma, NC exp, K log2, 2 NC K divisions, and the rest:
    the scaling 2K, the components' sums NC (3K + 4), the weights 2 NC,
    the posterior mean 4 NC K, the terms 4K."""
    c = EFFN_COSTS
    return (NC * (K + 1) * c["lgamma"] + NC * c["exp"] + K * c["log2"]
            + 2 * NC * K * c["div"] + 2 * K + NC * (3 * K + 4) + 2 * NC
            + 4 * NC * K + 4 * K)


def effn_steps(effn, nseq):
    """The bisection's f evaluations a model, from its result: 1 where
    the target was met at full counts (effn == nseq), else the full-count
    test and the midpoints until hi - lo < 0.01 (an exact f == 0, which
    would stop sooner, is not seen)."""
    if effn == nseq:
        return 1
    width, steps = float(nseq), 2
    while not width < 0.01:
        width *= 0.5
        steps += 1
    return steps


def table_bytes(bt):
    """Bytes of a bank's tables: emissions [H, K, Mp], transitions
    [H, 8, Mp], f32."""
    return 4 * bt.H * (bt.K + 8) * bt.Mp


def grid_cells(bt, lens):
    """DP cells of an all-vs-all grid at the models' own M."""
    import numpy as np
    return float(np.asarray(bt.M, np.float64).sum()) * float(
        np.asarray(lens, np.float64).sum())


def flank_rows_bytes(bt, codes, lens):
    """Bytes the flank kernel must move beyond its inputs on a grid: per
    pair the three output rows, 4 B x (Lc + 1) each, and the stored
    Forward specials, 20 B a row written and read back."""
    import numpy as np
    L = np.asarray(lens, np.float64)
    return bt.H * (12.0 * len(L) * (np.asarray(codes).shape[1] + 1)
                   + 40.0 * float((L + 1).sum()))


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed_call(fn):
    """(fn(), its CUDA-event ms): one call, no warm-up. The plain
    versions are timed so, on the call whose result is compared: a
    second run would only repeat the same many small launches."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def read_fasta_dict(path):
    from witch_tpu_torch.io.fasta import read_fasta
    return dict(read_fasta(path))


# ---------------------------------------------------------------------
def rows_vs_jax(label, masked, golden, names=None):
    """A run's masked rows against the JAX package's (golden: (file under
    tests/golden/, the least count of equal rows)): prints n/N rows equal
    and names up to JAX_DIFF_SHOWN differing rows, each with its first
    differing column (or that the run has no row for it); fails below the
    least count. `names`: the rows compared (default: all the golden's)."""
    from witch_tpu_torch.io.fasta import read_fasta
    path, least = golden
    with gzip.open(os.path.join(GOLD, path), "rt") as f:
        ref = dict(read_fasta(f))
    names = list(ref) if names is None else list(names)
    differ = [n for n in names if masked.get(n) != ref.get(n)]
    say("  %s vs the JAX package's rows (%s): %d/%d rows equal"
        % (label, path, len(names) - len(differ), len(names)))
    for n in differ[:JAX_DIFF_SHOWN]:
        a, b = masked.get(n), ref.get(n)
        if a is None or b is None:
            say("    row %s: %s" % (n, "no row in this run" if a is None
                                    else "not in the golden"))
            continue
        col = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        say("    row %s differs from column %d (%d columns differ)"
            % (n, col, sum(x != y for x, y in zip(a, b))
               + abs(len(a) - len(b))))
    check(len(names) - len(differ) >= least,
          "%s: %d/%d rows equal the JAX package's (at least %d, the count "
          "of the first chip run)" % (label, len(names) - len(differ),
                                      len(names), least))
    return len(names) - len(differ)


def phase_forward(dev, result):
    import numpy as np
    import torch
    from witch_tpu_torch.benchlib import (load_bench_assets,
                                          native_args_from_bank)
    from witch_tpu_torch.hmm.profile import null1_score
    from witch_tpu_torch.native import _domaindef
    from witch_tpu_torch.device import bank_to_torch
    from witch_tpu_torch.ops.forward import (LN2, forward_nats,
                                             forward_nats_ref, null1_bits)

    say("== phase 2a: forward kernel vs plain, bench_assets grid")
    banks, z = load_bench_assets(os.path.join(ROOT, "bench_assets.npz"))
    codes, lens = z["codes"], z["lens"]
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    bts = [bank_to_torch(b, dev) for b in banks]
    err = 0.0
    ms = plain_ms = 0.0
    cells = nbytes = 0.0
    bits_k = []
    for b, bt in zip(banks, bts):
        cells += grid_cells(bt, lens)
        nbytes += table_bytes(bt) + 4 * codes.size + 4 * len(lens) * bt.H
        k = forward_nats(bt, c, ln)
        p, tp = timed_call(lambda: forward_nats_ref(bt, c, ln,
                                                    elems=1 << 26))
        torch.cuda.synchronize()
        err = max(err, float(((k - p).abs() / LN2).max()))
        ms += cuda_ms(lambda: forward_nats(bt, c, ln), 3)
        plain_ms += tp
        bits_k.append(k.double().cpu().numpy() / LN2
                      - null1_bits(lens)[:, None])
        say("  bank H=%d Mp=%d: max|dbits| kernel-plain %.3g"
            % (bt.H, bt.Mp, err))
    n_pairs = sum(b.H for b in banks) * len(lens)
    say("  grid %d pairs: kernel %.2f ms, plain %.2f ms" % (
        n_pairs, ms, plain_ms))
    check(err <= 1e-3, "forward kernel vs plain |dbits| %.3g <= 1e-3" % err)

    rng = np.random.default_rng(20260820)
    worst = 0.0
    per_bank = [2000 * b.H // sum(x.H for x in banks) for b in banks]
    per_bank[0] += 2000 - sum(per_bank)
    for bi, (b, n) in enumerate(zip(banks, per_bank)):
        hs = rng.integers(0, b.H, n)
        qs = rng.integers(0, len(lens), n)
        for h in np.unique(hs):
            sel = qs[hs == h]
            ql = [np.ascontiguousarray(codes[q, :lens[q]]) for q in sel]
            f = np.asarray(_domaindef.forward_targets_exact(
                *native_args_from_bank(b, h), ql, 4))
            ref = (f - np.array([null1_score(len(x)) for x in ql])) \
                / np.log(2.0)
            worst = max(worst, float(np.abs(ref - bits_k[bi][sel, h])
                                     .max()))
    check(worst <= 1e-3, "forward kernel vs native on 2000 pairs |dbits| "
          "%.3g <= 1e-3" % worst)
    result["forward"] = dict(max_abs_err=max(err, worst), ms=ms,
                             plain_ms=plain_ms, cells=cells, bytes=nbytes)
    return banks, codes, lens


def phase_forward_path(calls, dev, result, label, n_plain=None):
    """The forward kernel on the inputs the main path gave it (recorded
    forward_bits calls): against the plain version (on the first n_plain
    queries when given) within 1e-3 bits, and its ms at these shapes."""
    import numpy as np
    import torch
    from witch_tpu_torch.ops.forward import (LN2, forward_nats,
                                             forward_nats_ref, fwd_layout)

    say("== phase %s: forward kernel on the main path's inputs" % label)
    err = ms = plain_ms = cells = nbytes = 0.0
    for bt, codes, lens in calls:
        cells += grid_cells(bt, lens)
        nbytes += table_bytes(bt) + 4 * np.asarray(codes).size \
            + 4 * len(lens) * bt.H
        c = torch.as_tensor(np.asarray(codes), dtype=torch.int32, device=dev)
        ln = torch.as_tensor(np.asarray(lens), dtype=torch.int32, device=dev)
        k = forward_nats(bt, c, ln)
        cs, ls = (c, ln) if n_plain is None else (c[:n_plain], ln[:n_plain])
        p, tp = timed_call(lambda: forward_nats_ref(bt, cs, ls,
                                                    elems=1 << 26))
        e = float(((k[:len(ls)] - p).abs() / LN2).max())
        err = max(err, e)
        t = cuda_ms(lambda: forward_nats(bt, c, ln), 3)
        ms += t
        plain_ms += tp
        say("  bank H=%d Mp=%d (layout, G, npl, Mpad %s), %d queries: "
            "kernel %.2f ms; %d queries vs plain |dbits| %.3g (plain %.2f "
            "ms)" % (bt.H, bt.Mp, fwd_layout(bt.Mp), len(lens), t, len(ls),
                     e, tp))
    check(calls and err <= 1e-3, "forward kernel on the %s path's inputs "
          "vs plain |dbits| %.3g <= 1e-3" % (label, err))
    b_ms, b_by = bound_ms("forward", cells, nbytes)
    say("  %.4g DP cells: bound %.3f ms (%s)" % (cells, b_ms, b_by))
    result["forward_" + label] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=b_ms)


class Recorder:
    """Records the inputs the main path hands to the gate, the OA kernel
    wrapper, the full-search prefilter (its flank inputs, decisions and
    copied rows) and the tree distances, so the checks can replay them
    against the plain versions and the native engine."""

    def __init__(self):
        import numpy as np
        import witch_tpu_torch.aligner as al
        import witch_tpu_torch.ensemble as en
        import witch_tpu_torch.hmm.flank_device as fd
        import witch_tpu_torch.hmm.gate_device as gd
        import witch_tpu_torch.pipeline as pl
        import witch_tpu_torch.tree_estimate as te
        self.gate, self.null2, self.oa = [], [], []
        self.full, self.counts, self.dist = [], [], []
        self.grid, self.fwd, self.fwd_bits, self.dgate = [], [], [], []
        self.overlay, self.effn = [], []
        orig_gate, orig_null2, orig_oa = (pl.evaluate_gate_device,
                                          gd.null2_envelopes, al.oa_columns)
        orig_full, orig_counts, orig_dist = (
            pl._full_search_gate, te.identity_counts, te.pairwise_distances)
        orig_grid = fd.prefilter_grid
        orig_fwd = pl.forward_bits
        orig_dgate = pl._device_gate
        orig_overlay = pl.overlay_scores
        orig_effn = en.effn_all

        def effn(counts, molecule, device):
            self.effn.append((list(counts), molecule))
            return orig_effn(counts, molecule, device)

        en.effn_all = effn

        def overlay(jobs, device, kc, nthreads, parent):
            self.overlay.append((list(jobs), kc))
            return orig_overlay(jobs, device, kc, nthreads, parent)

        pl.overlay_scores = overlay

        def fwd(bt, codes, lens):
            self.fwd.append((bt, np.array(codes), np.array(lens)))
            bits = orig_fwd(bt, codes, lens)
            self.fwd_bits.append(bits)
            return bits

        pl.forward_bits = fwd

        def dgate(ens, indices, banks, *a, **kw):
            self.dgate.append((ens, list(indices), banks))
            return orig_dgate(ens, indices, banks, *a, **kw)

        pl._device_gate = dgate

        def full(ens, indices, *a, **kw):
            drop = orig_full(ens, indices, *a, **kw)
            self.full.append((ens, list(indices), a[5], drop))
            return drop

        def counts(aln, device):
            m, d = orig_counts(aln, device)
            self.counts.append((aln, m, d))
            return m, d

        def dist(aln, device):
            d = orig_dist(aln, device)
            self.dist.append(d)
            return d

        def grid(banks_t, bank_cols, codes, lens, H, **kw):
            dec, rows = orig_grid(banks_t, bank_cols, codes, lens, H, **kw)
            self.grid.append((banks_t, [list(c) for c in bank_cols],
                              codes, np.asarray(lens, np.int32), dec, rows))
            return dec, rows

        pl._full_search_gate = full
        fd.prefilter_grid = grid
        te.identity_counts, te.pairwise_distances = counts, dist

        def gate(*a, **kw):
            res, stats = orig_gate(*a, **kw)
            self.gate.append((a, copy.deepcopy(res)))
            return res, stats

        def null2(bt, entries):
            self.null2.append((bt, list(entries)))
            return orig_null2(bt, entries)

        def oa(banks_t, bank_row, pairs, Ldmax=0):
            self.oa.append((banks_t, bank_row, list(pairs), Ldmax))
            return orig_oa(banks_t, bank_row, pairs, Ldmax=Ldmax)

        pl.evaluate_gate_device, gd.null2_envelopes, al.oa_columns = \
            gate, null2, oa

    def clear(self):
        for x in (self.gate, self.null2, self.oa, self.full, self.counts,
                  self.dist, self.grid, self.fwd, self.fwd_bits, self.dgate,
                  self.overlay, self.effn):
            x.clear()


def timed(fn, *a):
    t0 = time.time()
    out = fn(*a)
    say("  [%s: %.1f s]" % (fn.__name__, time.time() - t0))
    return out


def run_cli(argv):
    from witch_tpu_torch import _build, witch_runner
    _build.reset_launches()
    t0 = time.time()
    out = witch_runner(argv)
    dt = time.time() - t0
    launches = dict(_build.LAUNCHES)
    return out, dt, launches


def print_breakdown(outdir):
    p = os.path.join(outdir, "runtime_breakdown.txt")
    lines = open(p).read().splitlines() if os.path.exists(p) else []
    say("  runtime breakdown:")
    for ln in lines:
        say("    " + ln.split("\t", 1)[-1])
    return lines


def amino_argv(outdir, extra=()):
    pre = AMINO[0]
    return ["-b", os.path.join(GOLD, pre + ".backbone.fasta"),
            "-e", os.path.join(GOLD, pre + ".backbone.tre"),
            "-q", os.path.join(GOLD, pre + ".queries.fasta"),
            "-d", outdir, "-o", "aligned.fasta", "--molecule",
            "amino"] + list(extra)


def spec_join(outdir):
    """(the align stage's speculative join line, its selection-drift
    count) of a CLI run, or (None, None) when the align stage ran
    without the speculative start."""
    import re
    for ln in open(os.path.join(outdir, "runtime_breakdown.txt")):
        m = re.search(r"speculative device OA join \((\d+) selection-drift",
                      ln)
        if m:
            return ln.split("\t", 1)[-1].strip(), int(m.group(1))
    return None, None


def run_amino(outdir, extra, label, oracle=True):
    """amino500 golden through witch_runner with `extra` flags; checks
    600/600 masked rows against the oracle when `oracle`, else reports
    the count. Returns the launches of the run."""
    from witch_tpu_torch.io.fasta import read_fasta
    pre, n_rows = AMINO
    out, dt, launches = run_cli(amino_argv(outdir, extra))
    print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    WALL[label] = dt
    mine = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    with gzip.open(os.path.join(
            GOLD, pre + ".aligned.masked.fasta.gz"), "rt") as f:
        gold = dict(read_fasta(f))
    bad = [n for n in gold if mine.get(n) != gold[n]]
    if oracle:
        check(len(gold) == n_rows and not bad,
              "%s: %d/%d masked rows equal the oracle"
              % (label, len(gold) - len(bad), n_rows))
    else:
        say("  %s: %d/%d masked rows equal the witch-ng oracle"
            % (label, len(gold) - len(bad), len(gold)))
    return launches


def phase_amino(tmp, rec):
    """amino500 with the speculative OA start off, then (recorded for the
    replays of 2b, 2c and 2f) with it on, the main path."""
    say("== phase 3: amino500 golden end to end (witch_runner), first "
        "with WITCH_TPU_SPEC_OA=0 (no speculative start)")
    os.environ["WITCH_TPU_SPEC_OA"] = "0"
    try:
        off_dir = os.path.join(tmp, "amino500_spec_off")
        off = run_amino(off_dir, [], "amino500 WITCH_TPU_SPEC_OA=0")
    finally:
        del os.environ["WITCH_TPU_SPEC_OA"]
    check(spec_join(off_dir)[0] is None and off["oa"] > 0,
          "amino500 WITCH_TPU_SPEC_OA=0: the align stage launched the OA "
          "kernel itself, no speculative join %s" % off)
    say("== phase 3: amino500 with the speculative OA start (the default)")
    rec.clear()
    outdir = os.path.join(tmp, "amino500")
    launches = run_amino(outdir, [], "amino500")
    check(all(launches[k] > 0 for k in ("forward", "null2", "oa")),
          "amino500: forward, null2 and oa launched on the main path %s"
          % launches)
    join, drift = spec_join(outdir)
    check(join is not None, "amino500: the align stage joined the "
          "speculative OA start (%s selection-drift host aligns): %s"
          % (drift, join))
    say("  amino500 wall: speculative start on %.2f s, off %.2f s"
        % (WALL["amino500"], WALL["amino500 WITCH_TPU_SPEC_OA=0"]))
    return launches


def phase_serve(tmp):
    """A resident server (python -m witch_tpu_torch serve) on the card:
    amino500 twice, byte-identical to phase 3's outputs, then a bench
    job; the server is killed at the end whatever happens. The same run
    as a fresh CLI process (WITCH_TPU_NO_DAEMON=1), while the server
    idles, gives what a server job saves."""
    from witch_tpu_torch.server import on_cuda, server_alive, submit

    say("== phase 3d: serve: amino500 twice and a bench job")
    jobs = os.path.join(tmp, "jobs")
    env = dict(os.environ)
    env.pop("WITCH_TPU_SPEC_OA", None)
    log_path = os.path.join(tmp, "server.log")
    t0 = time.time()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "witch_tpu_torch", "serve", "-d", jobs,
             "--max-idle", "300"], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL)
    try:
        while not server_alive(jobs):
            if proc.poll() is not None or time.time() - t0 > 180:
                raise AssertionError("server did not start (rc %s): %s" % (
                    proc.poll(), open(log_path).read()[-3000:]))
            time.sleep(0.2)
        say("  server up (heartbeat) in %.2f s" % (time.time() - t0))
        ref = os.path.join(tmp, "amino500")
        # what a server job saves: the same run as a fresh CLI process
        fresh = os.path.join(tmp, "fresh_amino500")
        t1 = time.time()
        r = subprocess.run([sys.executable, "-m", "witch_tpu_torch"]
                           + amino_argv(fresh), cwd=ROOT, env=dict(
                               env, WITCH_TPU_NO_DAEMON="1"),
                           capture_output=True, text=True, timeout=600)
        WALL["fresh process"] = time.time() - t1
        check(r.returncode == 0 and open(os.path.join(
            fresh, "aligned.fasta"), "rb").read() == open(os.path.join(
                ref, "aligned.fasta"), "rb").read(),
            "a fresh CLI process: aligned.fasta byte-identical to phase "
            "3's, %.2f s (rc %d)" % (WALL["fresh process"], r.returncode))
        first = None
        for k in range(2):
            outdir = os.path.join(tmp, "serve_amino500_%d" % k)
            t1 = time.time()
            res = submit(jobs, amino_argv(outdir), timeout_s=600,
                         dead_server_s=120)
            wait = time.time() - t1
            check(res["ok"] and on_cuda(res["device"])
                  and res["cards"] == [res["device"]],
                  "serve job %d ok on %s, scored on %s (%s)"
                  % (k, res["device"], res["cards"], res.get("error")))
            same = [open(os.path.join(outdir, f), "rb").read()
                    == open(os.path.join(ref, f), "rb").read()
                    for f in ("aligned.fasta", "aligned.masked.fasta")]
            check(all(same), "serve job %d: aligned.fasta and "
                  "aligned.masked.fasta byte-identical to phase 3's" % k)
            check(all(res["launches"][n] > 0 for n in (
                "forward", "null2", "oa")),
                "serve job %d: forward, null2 and oa launched in the server "
                "%s" % (k, res["launches"]))
            say("  job %d: %.2f s in the server (%.2f s submit to done); "
                "phase 3 in process %.2f s; a fresh CLI process %.2f s"
                % (k, res["seconds"], wait, WALL["amino500"],
                   WALL["fresh process"]))
            first = first or res["launches"]
        t1 = time.time()
        res = submit(jobs, [], timeout_s=600, dead_server_s=120, extra={
            "kind": "bench", "assets": os.path.join(ROOT, "bench_assets.npz"),
            "reps": 3})
        check(res["ok"] and set(res["output"]) == {
            "dt", "padded_cells", "total_pairs", "true_cells", "backend",
            "warm_s"} and res["output"]["backend"] == "cuda",
            "serve bench job: bench_tier's keys on cuda (%s)"
            % (res.get("error") or res["output"]))
        say("  bench job: %.2f s in the server, grid %.6f s, warm %.3f s"
            % (res["seconds"], res["output"]["dt"],
               res["output"]["warm_s"]))
    finally:
        proc.kill()
        proc.wait()
    say("  server log: " + " | ".join(
        open(log_path).read().strip().splitlines()[-4:]))
    return first


def phase_bench(result):
    """witch_tpu_torch/tools/bench.py in this process: its JSON line,
    beside phase 2a's kernel ms of the same grid."""
    import importlib.util
    say("== phase 2g: bench tier (witch_tpu_torch/tools/bench.py)")
    spec = importlib.util.spec_from_file_location(
        "witch_bench_tool", os.path.join(ROOT, "witch_tpu_torch", "tools",
                                         "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    line = mod.main(["--reps", "3"])
    check(set(line) == {"metric", "value", "unit", "vs_baseline",
                        "gcups_true", "gcups_padded", "seconds_per_full_grid",
                        "backend", "domaindef_pairs_per_s_4t"},
          "bench line has bench.py's keys")
    say("  seconds_per_full_grid %.6f s; phase 2a's two banks' kernel ms "
        "%.3f ms" % (line["seconds_per_full_grid"], result["forward"]["ms"]))
    result["bench_line"] = line


def phase_null2(rec, dev, result, label="2b: null2 kernel vs plain, "
                "amino500 gate envelopes", key="null2", sample=None,
                gate=True):
    """The null2 kernel on the envelopes the main path gave it (recorded
    null2_envelopes calls): against the plain version within 1e-4
    relative (on a seeded subset of `sample` envelopes when given), its ms
    on all of them, and with `gate` the assembled gate tuples against the
    native engine. Relative error is |k - p| / max(|p|, floor): floor
    1e-2 for useI, usetot and n2dot; 1 nat for envsc, a log score whose
    f32 error is absolute (a sum of Ld logs: ~1e-5 nats at 700 rows, which
    a score near 0 turns into any relative error), so it is held to 1e-4
    nats there (1.4e-4 bits; the parity bar for null2 is ~1e-4 bits)."""
    import numpy as np
    import torch
    from witch_tpu_torch import _build
    from witch_tpu_torch.native import _domaindef
    from witch_tpu_torch.ops.null2 import (NCODE, _pack, null2_nats,
                                           null2_nats_ref)

    say("== phase " + label)
    worst = 0.0
    abs_err = 0.0
    ms = plain_ms = 0.0
    cells = nbytes = 0.0
    n_env = n_cmp = launches = 0
    rng = np.random.default_rng(1016)
    total = sum(len(e) for _, e in rec.null2)
    for bt, entries in rec.null2:
        if not entries:
            continue
        n_env += len(entries)
        n_res = sum(len(sub) for _, sub, _ in entries)
        cells += float(sum(len(sub) * int(bt.M[row])
                           for row, sub, _ in entries))
        nbytes += table_bytes(bt) + 4 * n_res + 4 * (3 + NCODE) * len(entries)
        pk = _pack(entries, dev)
        n0 = _build.LAUNCHES["null2"]
        sk, dk = null2_nats(bt, *pk)
        launches += _build.LAUNCHES["null2"] - n0
        sub = list(range(len(entries)))
        if sample is not None and total > sample:
            k = max(1, round(sample * len(entries) / total))
            sub = sorted(rng.choice(len(entries), min(k, len(entries)),
                                    replace=False).tolist())
        pks = _pack([entries[t] for t in sub], dev)
        (sp, dp), tp = timed_call(lambda: null2_nats_ref(
            bt, *pks, chunk=512 if sample else 1024))
        n_cmp += len(sub)
        idx = torch.as_tensor(sub, device=dev)
        for a, b, floor in ((sk[idx, :1], sp[:, :1], 1.0),
                            (sk[idx, 1:], sp[:, 1:], 1e-2),
                            (dk[idx], dp, 1e-2)):
            d = (a - b).abs()
            abs_err = max(abs_err, float(d.max()))
            worst = max(worst, float((d / b.abs().clamp(min=floor)).max()))
        ms += cuda_ms(lambda: null2_nats(bt, *pk), 2 if sample else 3)
        plain_ms += tp
    b_ms, b_by = bound_ms("null2", cells, nbytes)
    say("  %d envelopes (%d against plain), %d launches: kernel %.2f ms, "
        "plain %.2f ms (on those %d); %.4g DP cells: bound %.3f ms (%s), "
        "stored rows 16 B per state-row %.3f ms at %.3g TB/s"
        % (n_env, n_cmp, launches, ms, plain_ms, n_cmp, cells, b_ms, b_by,
           16 * cells / HBM_BYTES_PER_S * 1e3, HBM_BYTES_PER_S / 1e12))
    check(n_env > 0 and worst <= 1e-4,
          "null2 kernel vs plain: max relative error %.3g <= 1e-4" % worst)
    result[key] = dict(max_abs_err=abs_err, max_rel_err=worst, ms=ms,
                       plain_ms=plain_ms, envelopes=n_env, cells=cells,
                       bytes=nbytes, bound_ms=b_ms, launches=launches,
                       rows_bytes_ms=16 * cells / HBM_BYTES_PER_S * 1e3)
    if not gate:
        return

    # assembled gate tuples vs the native engine on the same flank rows
    nbad = npairs = 0
    dsb = dse = dss = 0.0
    for args, res in rec.gate:
        _banks_t, _loc, allargs, qcodes, by_j, flank_rows = args[:6]
        for j, qlist in sorted(by_j.items()):
            mo, pb, pe = flank_rows[j]
            cl = [np.ascontiguousarray(qcodes[q], np.int32) for q in qlist]
            nat = _domaindef.evaluate_targets_rows(
                *allargs[j], cl, 42, 200, 1, 0, mo, pb, pe, 4)
            got = res[j]
            npairs += len(qlist)
            for col in (0, 1, 6):
                nbad += int((np.asarray(nat[col]) !=
                             np.asarray(got[col])).sum())
            dsb = max(dsb, float(np.abs(np.asarray(nat[2]) - got[2]).max()))
            dse = max(dse, float(np.abs(np.asarray(nat[4]) - got[4]).max()))
            dss = max(dss, float(np.abs(np.asarray(nat[5]) - got[5]).max()))
    say("  gate vs native on %d pairs: integer mismatches %d, |dsbias| "
        "%.3g, |dsenv| %.3g, |dsbsum| %.3g" % (npairs, nbad, dsb, dse, dss))
    check(npairs > 0 and nbad == 0 and dsb < 2e-3 and dse < 2e-3
          and dss < 5e-3, "gate assembly vs native evaluate_targets_rows")


def oa_kernel_ms(bt, pk, Ldmax, reps=3):
    """The OA kernels' own CUDA-event ms per oa_nats call (mean of reps
    after a warm-up; _build.KERNEL_MS, without the wrapper's host work),
    and the whole call's."""
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.oa import oa_nats
    k0 = _build.KERNEL_MS["oa"]
    call = cuda_ms(lambda: oa_nats(bt, *pk, Ldmax=Ldmax), reps)
    return (_build.KERNEL_MS["oa"] - k0) / (reps + 1), call


def oa_compare(bt, pairs_rows, Ldmax, label):
    """Kernel vs plain on (bank_row, codes) pairs of one bank. Returns
    (kernel cols list, margins, oks, n above-guard mismatches vs plain,
    max |dmargin|, kernel ms, plain ms)."""
    import numpy as np
    import torch
    from witch_tpu_torch.ops.oa import oa_layout, oa_nats, oa_ref, pack_pairs
    pk = pack_pairs(bt, pairs_rows)
    ck, sk = oa_nats(bt, *pk, Ldmax=Ldmax)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    cp, sp = oa_ref(bt, *pk)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])         # one call, no warm-up
    ck, sk, cp, sp = (x.cpu().numpy() for x in (ck, sk, cp, sp))
    off = pk[3].cpu().numpy()
    cols, bad = [], 0
    for t, (_, c) in enumerate(pairs_rows):
        a = ck[off[t]:off[t] + len(c)]
        cols.append(a.astype(np.int64))
        if sk[t, 0] >= OA_GUARD and sk[t, 1] > 0.5 \
                and not np.array_equal(a, cp[off[t]:off[t] + len(c)]):
            bad += 1
    fin = np.isfinite(sk[:, 0]) & np.isfinite(sp[:, 0])
    dm = float(np.abs(sk[fin, 0] - sp[fin, 0]).max()) if fin.any() else 0.0
    ms, call = oa_kernel_ms(bt, pk, Ldmax)
    say("  %s (layout, G, npl, Mpad %s): %d pairs, kernel %.2f ms (call "
        "%.2f), plain %.2f ms, |dmargin| %.3g"
        % (label, oa_layout(bt.Mp), len(pairs_rows), ms, call, plain_ms,
           dm))
    return cols, sk[:, 0], sk[:, 1] > 0.5, bad, dm, ms, plain_ms


def oa_padded_cells(bt, lst):
    """DP cells at the OA kernel's padded width (its stored rows)."""
    from witch_tpu_torch.ops.oa import oa_layout
    return float(sum(len(c) for *_, c in lst)) * oa_layout(bt.Mp)[3]


def phase_oa(rec, banks_bench, codes, lens, dev, result):
    import numpy as np
    from witch_tpu_torch.benchlib import native_args_from_bank
    from witch_tpu_torch.native import _domaindef
    from witch_tpu_torch.device import bank_to_torch

    say("== phase 2c: oa kernel vs plain and native")
    bad_p = bad_n = 0
    dmax = ms = plain_ms = 0.0
    cells = nbytes = padc = 0.0
    n = 0
    for banks_t, bank_row, pairs, Ldmax in rec.oa:
        by_bank = {}
        for idx, c in pairs:
            bi, row = bank_row[int(idx)]
            by_bank.setdefault(bi, []).append((idx, row, c))
        aligner = REC_ALIGNER[0]
        for bi, lst in sorted(by_bank.items()):
            cols, mg, ok, bad, dm, t_k, t_p = oa_compare(
                banks_t[bi], [(r, c) for _, r, c in lst], Ldmax,
                "amino500 bank %d" % bi)
            ref = aligner.native_columns([(i, c) for i, _, c in lst])
            bad_p += bad
            bad_n += sum(1 for t in range(len(lst))
                         if mg[t] >= OA_GUARD and ok[t]
                         and not np.array_equal(cols[t], ref[t]))
            dmax = max(dmax, dm)
            ms += t_k
            plain_ms += t_p
            n += len(lst)
            bt = banks_t[bi]
            cells += float(sum(len(c) * int(bt.M[r]) for _, r, c in lst))
            nbytes += table_bytes(bt) + sum(8 * len(c) + 8 for *_, c in lst)
            padc += oa_padded_cells(bt, lst)
    check(n > 0 and bad_p == 0 and bad_n == 0 and dmax <= 1e-4,
          "oa amino500: %d pairs, above-guard mismatches vs plain %d, "
          "vs native %d; finite margins within %.3g <= 1e-4 of plain"
          % (n, bad_p, bad_n, dmax))
    result["oa"] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
                        pairs=n, cells=cells, bytes=nbytes,
                        rows_bytes_ms=ROW_BYTES["oa"] * padc
                        / HBM_BYTES_PER_S * 1e3)

    # 256 bench_assets pairs (DNA, Mp 1,312 and 2,720)
    rng = np.random.default_rng(7)
    nb = 0
    bad_b = bad_bn = 0
    dmb = ms_b = plain_b = cells_b = nbytes_b = padc_b = 0.0
    for bi, b in enumerate(banks_bench):
        k = 128
        hs = rng.integers(0, b.H, k)
        qs = rng.integers(0, len(lens), k)
        pr = [(int(h), np.ascontiguousarray(codes[q, :lens[q]]))
              for h, q in zip(hs, qs)]
        bt = bank_to_torch(b, dev)
        cols, mg, ok, bad, dm, t_k, t_p = oa_compare(
            bt, pr, int(lens.max()), "bench bank %d" % bi)
        dmb = max(dmb, dm)
        bad_b += bad
        ms_b += t_k
        plain_b += t_p
        cells_b += float(sum(len(c) * int(bt.M[h]) for h, c in pr))
        nbytes_b += table_bytes(bt) + sum(8 * len(c) + 8 for _, c in pr)
        padc_b += oa_padded_cells(bt, pr)
        for t, (h, c) in enumerate(pr):
            a = native_args_from_bank(b, h)
            d = [np.ascontiguousarray(
                (np.isfinite(x)).astype(np.uint8)) for x in a[1:]]
            ref = np.asarray(_domaindef.posterior_oa_pair(
                *a, c, len(c), 0, *d))[:len(c)]
            if mg[t] >= OA_GUARD and ok[t] and not np.array_equal(
                    cols[t], ref):
                bad_bn += 1
        nb += len(pr)
    check(bad_b == 0 and bad_bn == 0 and dmb <= 1e-4,
          "oa bench_assets: %d pairs, above-guard mismatches vs plain %d, "
          "vs native %d; finite margins within %.3g <= 1e-4 of plain"
          % (nb, bad_b, bad_bn, dmb))
    b_ms, b_by = bound_ms("oa", cells_b, nbytes_b)
    result["oa_bench"] = dict(max_abs_err=dmb, ms=ms_b, plain_ms=plain_b,
                              pairs=nb, bound_ms=b_ms,
                              rows_bytes_ms=ROW_BYTES["oa"] * padc_b
                              / HBM_BYTES_PER_S * 1e3)


def phase_oa_path(rec, dev, result, label, key, sample=64, first=False,
                  layout=None):
    """The OA kernel on the pairs a main path gave it (its first recorded
    oa_columns call since rec.clear(); validate_oa's sample comes after
    it): ms and launches over all of them, and both bounds;
    a seeded sample (the `sample` longest pairs and `sample` more at
    random) against plain and native above the guard, margins within
    1e-4 of plain. `first`: the first version on the same calls too (one
    timed call each; its columns and margins equal the kernel's);
    `layout`: the layout every bank must take."""
    import numpy as np
    import torch
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.oa import oa_layout, oa_nats, pack_pairs

    say("== phase " + label)
    banks_t, bank_row, pairs, Ldmax = rec.oa[0]
    by_bank = {}
    for p, (idx, c) in enumerate(pairs):
        bi, row = bank_row[int(idx)]
        by_bank.setdefault(bi, []).append((p, row, c))
    ms = cells = nbytes = padc = ms_first = 0.0
    launches = n_first = 0
    same_first = True
    for bi, lst in sorted(by_bank.items()):
        bt = banks_t[bi]
        pk = pack_pairs(bt, [(r, c) for _, r, c in lst])
        n0 = _build.LAUNCHES["oa"]
        ck, sk = oa_nats(bt, *pk, Ldmax=Ldmax)
        torch.cuda.synchronize()
        nl = _build.LAUNCHES["oa"] - n0
        t, call = oa_kernel_ms(bt, pk, Ldmax)
        launches += nl
        ms += t
        cells += float(sum(len(c) * int(bt.M[r]) for _, r, c in lst))
        nbytes += table_bytes(bt) + sum(8 * len(c) + 8 for *_, c in lst)
        padc += oa_padded_cells(bt, lst)
        say("  bank %d Mp %d (layout, G, npl, Mpad %s): %d pairs, %d "
            "launches, kernel %.2f ms (call %.2f)"
            % (bi, bt.Mp, oa_layout(bt.Mp), len(lst), nl, t, call))
        if layout is not None:
            check(oa_layout(bt.Mp)[0] == layout, "%s: OA at Mp %d takes "
                  "layout %d" % (key, bt.Mp, layout))
        if first:
            k0, n0 = _build.KERNEL_MS["oa"], _build.LAUNCHES["oa"]
            cf, sf = oa_nats(bt, *pk, Ldmax=Ldmax, first_version=True)
            torch.cuda.synchronize()
            tf = _build.KERNEL_MS["oa"] - k0
            n_first += _build.LAUNCHES["oa"] - n0
            ms_first += tf
            ckh, cfh = ck.cpu().numpy(), cf.cpu().numpy()
            skh, sfh = sk.cpu().numpy(), sf.cpu().numpy()
            off = pk[3].cpu().numpy()
            fin = np.isfinite(skh[:, 0])
            same_first &= np.array_equal(skh[:, 1], sfh[:, 1]) \
                and np.array_equal(fin, np.isfinite(sfh[:, 0]))
            same_first &= float(np.abs(sfh[fin, 0] - skh[fin, 0]).max(
                initial=0.0)) <= 1e-4
            for t, (_, _, c) in enumerate(lst):
                if skh[t, 0] >= OA_GUARD and skh[t, 1] > 0.5:
                    a = slice(off[t], off[t] + len(c))
                    same_first &= np.array_equal(ckh[a], cfh[a])
            say("    first version on the same pairs: %.2f ms in %d "
                "launches" % (tf, _build.LAUNCHES["oa"] - n0))
    if first:
        check(same_first and ms < ms_first, "%s: the kernel (%.2f ms) "
              "faster than the first version (%.2f ms) on the same %d "
              "pairs; the same flags, columns above the guard, finite "
              "margins within 1e-4" % (key, ms, ms_first, len(pairs)))
    b_ms, b_by = bound_ms("oa", cells, nbytes)
    rows_ms = ROW_BYTES["oa"] * padc / HBM_BYTES_PER_S * 1e3
    say("  %d pairs, %d launches: kernel %.2f ms; %.4g DP cells: bound "
        "%.3f ms (%s), stored rows 17 B per state-row %.3f ms"
        % (len(pairs), launches, ms, cells, b_ms, b_by, rows_ms))
    lens = np.array([len(c) for _, c in pairs])
    order = np.argsort(-lens, kind="stable")
    pick = set(order[:sample].tolist())
    rest = order[sample:]
    if len(rest):
        rng = np.random.default_rng(1017)
        pick |= set(rng.choice(rest, min(sample, len(rest)),
                               replace=False).tolist())
    bad_p = bad_n = 0
    dmax = plain_ms = 0.0
    aligner = REC_ALIGNER[0]
    for bi, lst in sorted(by_bank.items()):
        sub = [(p, r, c) for p, r, c in lst if p in pick]
        if not sub:
            continue
        cols, mg, ok, bad, dm, _, t_p = oa_compare(
            banks_t[bi], [(r, c) for _, r, c in sub], Ldmax,
            "%s sample, bank %d" % (key, bi))
        ref = aligner.native_columns([pairs[p] for p, _, _ in sub])
        bad_p += bad
        bad_n += sum(1 for t in range(len(sub))
                     if mg[t] >= OA_GUARD and ok[t]
                     and not np.array_equal(cols[t], ref[t]))
        dmax = max(dmax, dm)
        plain_ms += t_p
    check(launches > 0 and bad_p == 0 and bad_n == 0 and dmax <= 1e-4,
          "oa on %s: %d sampled pairs of %d, above-guard mismatches vs "
          "plain %d, vs native %d; finite margins within %.3g <= 1e-4 of "
          "plain" % (key, len(pick), len(pairs), bad_p, bad_n, dmax))
    result["oa_" + key] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
                               launches=launches, pairs=len(pairs),
                               cells=cells, bound_ms=b_ms, bound_by=b_by,
                               rows_bytes_ms=rows_ms)
    if first:
        result["oa_" + key].update(ms_first_version=ms_first,
                                   launches_first_version=n_first)


def phase_dna(tmp, rec):
    from witch_tpu_torch.aligner import validate_oa

    say("== phase 4: seeded DNA scenario D, 1000 backbone + 1000 queries")
    data = os.path.join(tmp, "dna1k")
    t0 = time.time()
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_scale_dataset.py"),
                    "--n", str(DNA_N), "--queries", str(DNA_N), "--seed",
                    "20260820", "--out", data], check=True,
                   capture_output=True, timeout=300)
    say("  dataset generated in %.2f s" % (time.time() - t0))
    outdir = os.path.join(tmp, "dna1k_out")
    rec.clear()
    out, dt, launches = run_cli([
        "-b", os.path.join(data, "backbone.aln.fasta.gz"),
        "-e", os.path.join(data, "backbone.tre"),
        "-q", os.path.join(data, "queries.fasta"),
        "-d", outdir, "-o", "aligned.fasta"])
    lines = print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    WALL["dna1k"] = dt
    from witch_tpu_torch.io.fasta import read_fasta
    qnames = [n for n, _ in read_fasta(os.path.join(data,
                                                    "queries.fasta"))]
    masked = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    ign_p = os.path.join(outdir, "ignored_queries.fasta")
    ignored = set(read_fasta_dict(ign_p)) if os.path.exists(ign_p) else set()
    missing = [q for q in qnames if q not in masked and q not in ignored]
    check(not missing, "dna1k: every query has a row or is ignored "
          "(%d rows, %d ignored)" % (len(qnames) - len(ignored),
                                     len(ignored)))
    bb = read_fasta_dict(os.path.join(data, "backbone.aln.fasta.gz"))
    bad = [n for n, s in bb.items() if masked.get(n) != s.upper()]
    check(not bad, "dna1k: %d/%d backbone rows equal the input"
          % (len(bb) - len(bad), len(bb)))
    check(all(launches[k] > 0 for k in ("forward", "null2", "oa",
                                         "overlay", "effn")),
          "dna1k: forward, null2, oa, overlay and effn launched on the main "
          "path %s" % launches)
    banks_t, bank_row, pairs, Ldmax = rec.oa[-1]
    v = validate_oa(REC_ALIGNER[0], pairs, Ldmax, sample=200, seed=1)
    check(v["above_guard"] == 0,
          "dna1k: 200 sampled OA pairs equal native above the guard "
          "(%d mismatched, all below the guard; %d re-aligned)"
          % (v["mismatched"], v["redo"]))
    gate = [ln.split("\t", 1)[-1].strip() for ln in lines
            if "device gate" in ln or "below-guard" in ln]
    ens = [ln.split("\t", 1)[-1].strip() for ln in open(
        os.path.join(outdir, "log.txt")) if "Ensemble of" in ln]
    say("  " + " | ".join(ens + gate))
    join, drift = spec_join(outdir)
    check(join is not None, "dna1k: the align stage joined the speculative "
          "OA start, %s selection-drift host aligns" % drift)
    dna1k_vs_jax(rec, data, masked, ignored)
    return launches


def overlay_chain_ms(rows_q):
    """The serial-chain bound of one overlay launch (csrc/overlay.cu)
    whose longest item has rows_q = ld x Q: that item's dependent f32
    operations a row on one thread (Forward: 2Q in the first delete pass
    + Q in the E fold's D part; Backward: Q in the B fold + 3Q in the
    first delete pass) x their latency. Launch B's posterior sums and
    null2 are left out, so it is a lower bound for both launches."""
    return rows_q * 7 * FP32_DEP_CYCLES / SM_CLOCK_HZ * 1e3


def native_scores32(jobs, nthreads):
    """exact_scores32 on the native engine, one job a worker: (ok, seq,
    pre) a job."""
    from concurrent.futures import ThreadPoolExecutor

    from witch_tpu_torch.native import _domaindef
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        return list(pool.map(
            lambda job: _domaindef.exact_scores32(*job[0], job[1], 1), jobs))


def overlay_differ(got, ref):
    """Pairs whose ok differs, or whose seq or pre differs where the
    native engine decides."""
    import numpy as np
    ok, seq, pre = got
    return sum(int(np.sum(ok[k] != o)) + int(np.sum((seq[k] != s)[o == 1]))
               + int(np.sum((pre[k] != p)[o == 1]))
               for k, (o, s, p) in enumerate(ref))


def phase_overlay(rec, dev, result):
    """4o: the print overlay on phase 4's band pairs, through the
    pipeline's routing (ops/overlay.py:overlay_scores) and through the
    split chain's card launcher alone, each against exact_scores32 on the
    same pairs; each launch's kernel ms beside its serial-chain bound;
    then one model too wide for the kernel, which falls back to the
    native engine and is counted."""
    import numpy as np
    from witch_tpu_torch import _build
    from witch_tpu_torch.core.alphabet import DNA
    from witch_tpu_torch.hmm.build import build_hmm, quantize_like_text
    from witch_tpu_torch.hmm.profile import configure
    from witch_tpu_torch.native import set_trace_alphabet
    from witch_tpu_torch.ops import overlay as ov
    from witch_tpu_torch.pipeline import _native_args
    from witch_tpu_torch.spans import span

    say("== phase 4o: exact-f32 overlay kernel on dna1k's band pairs")
    check(rec.overlay, "dna1k: the pipeline ran the print overlay")
    jobs, kc = rec.overlay[-1]
    set_trace_alphabet("dna")
    pairs = sum(len(cl) for _, cl in jobs)
    t0 = time.time()
    ref = native_scores32(jobs, 8)
    t_native = time.time() - t0
    n0 = _build.LAUNCHES["overlay"]
    with span("scoring.overlay", kernels="overlay") as sp:
        got = ov.overlay_scores(jobs, dev, kc, 8, sp)
    bad = overlay_differ(got, ref)
    cnt = {k: v for k, v in sp.counters.items() if k != "kernel_ms"}
    check(bad == 0 and cnt["launches"] == 2
          and _build.LAUNCHES["overlay"] - n0 == 2,
          "4o: overlay_scores on %d pairs of %d models: 2 launches, ok, seq "
          "and pre bit-identical to exact_scores32 (%d differ)"
          % (pairs, len(jobs), bad))
    check(cnt["device_pairs"] >= 0.95 * pairs,
          "4o: the card decided %d of %d pairs (%s)"
          % (cnt["device_pairs"], pairs, cnt))
    card = ov.CardLauncher(dev, kc)
    t0 = time.time()
    ok, seq, pre, _ = ov.exact_scores(jobs, card, 8)
    t_card = time.time() - t0
    bad_card = overlay_differ((ok, seq, pre), ref)
    check(bad_card == 0 and [c[0] for c in card.calls] == [0, 1],
          "4o: the card launcher alone: launches A and B, %d pairs differ"
          % bad_card)
    launch = {}
    for (mode, items, rows_q, ms), tag in zip(card.calls, "AB"):
        launch[tag] = dict(items=items, rows_q=rows_q, ms=ms,
                           bound_ms=overlay_chain_ms(rows_q))
        say("  launch %s: %d items, kernel %.2f ms, serial-chain bound "
            "%.2f ms (longest item ld x Q %d)"
            % (tag, items, ms, launch[tag]["bound_ms"], rows_q))
    kms = sum(x["ms"] for x in launch.values())
    bound = sum(x["bound_ms"] for x in launch.values())
    say("  card %.3f s (kernel %.2f ms; bound %.2f ms), native engine "
        "%.3f s (8 threads) on the same pairs" % (t_card, kms, bound,
                                                   t_native))
    # a model one stripe past Q_MAX: every pair to exact_scores32
    rng = np.random.default_rng(19)
    M = 4 * ov.Q_MAX + 4
    base = rng.integers(0, 4, M)
    rows = np.array([np.where(rng.random(M) < 0.1, rng.integers(0, 4, M),
                              base) for _ in range(6)], np.uint8)
    core = quantize_like_text(build_hmm(rows, DNA, "dna"))
    frags = []
    for _ in range(4):
        a = int(rng.integers(0, M - 300))
        frags.append(np.ascontiguousarray(base[a:a + 200], np.int32))
    wide = [(_native_args(configure(core, multihit=True)), frags)]
    with span("scoring.overlay", kernels="overlay") as spw:
        gotw = ov.overlay_scores(wide, dev, kc, 8, spw)
    cw = spw.counters
    check(cw["wide"] == len(frags) and cw["device_pairs"] == 0
          and cw["launches"] == 0
          and overlay_differ(gotw, native_scores32(wide, 8)) == 0,
          "4o: a %d-state model's %d pairs fell back to the native engine "
          "with its scores (%s)" % (M, len(frags), cw))
    result["overlay"] = dict(pairs=pairs, models=len(jobs), ms=kms,
                             launch=launch, bound_ms=bound,
                             bound_by="serial chains", differ=bad + bad_card,
                             card_s=t_card, native_s=t_native,
                             counters=cnt)
    say(json.dumps({"overlay": result["overlay"]}))


def phase_effn(rec, dev, result):
    """4h: the entropy-weighting kernel on the counts phase 4's ensemble
    handed to ops/effn.py:effn_all (dna1k's 285 models): one launch; every
    effn bit for bit the plain version's on the same card tensors and the
    host's (entropy_weight); the smallest margins within EFFN_MINF_TOL of
    the plain version's, none below the guard; the kernel's ms beside the
    plain version's, the host bisection's and its f64 bound."""
    import numpy as np
    import torch
    from witch_tpu_torch import _build
    from witch_tpu_torch.hmm.build import hmm_effn
    from witch_tpu_torch.ops import effn as F

    say("== phase 4h: entropy-weighting kernel on dna1k's models")
    check(rec.effn, "dna1k: the pipeline ran the ensemble's entropy "
          "weighting")
    counts, molecule = rec.effn[-1]
    args = F.effn_args(counts, molecule, dev)
    _build.LAUNCHES["effn"] = 0
    k0 = _build.KERNEL_MS["effn"]
    got, minf = F.effn_card(*args)
    ms = _build.KERNEL_MS["effn"] - k0
    check(_build.LAUNCHES["effn"] == 1,
          "4h: one launch for %d models" % len(counts))
    torch.cuda.synchronize()
    t0 = time.time()
    ref, minf_ref = F.effn_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    host = [hmm_effn(c, molecule) for c in counts]
    host_ms = (time.time() - t0) * 1e3
    got, minf = got.cpu().tolist(), minf.cpu().numpy()
    ref, minf_ref = ref.cpu().tolist(), minf_ref.cpu().numpy()
    differ = sum(a != b for a, b in zip(got, ref))
    differ_host = sum(a != b for a, b in zip(got, host))
    check(differ == 0 and differ_host == 0,
          "4h: %d effn bit for bit the plain version's and the host's (%d, "
          "%d differ)" % (len(got), differ, differ_host))
    dminf = float(np.max(np.abs(minf - minf_ref)))
    check(dminf <= EFFN_MINF_TOL and float(minf.min()) >= F.EFFN_GUARD,
          "4h: smallest |f| within %.3g bits of the plain version's (%.3g), "
          "none below the guard (smallest %.3g)"
          % (EFFN_MINF_TOL, dminf, float(minf.min())))
    t_ms = cuda_ms(lambda: F.effn_card(*args), 5)
    M = np.diff(args[1].cpu().numpy())
    nseq = [c.nseq for c in counts]
    steps = np.array([effn_steps(e, n) for e, n in zip(got, nseq)])
    col_steps = float((M * steps).sum())
    K, NC = counts[0].ecounts.shape[1], args[4].shape[0]
    ops = effn_ops_per_column(K, NC)
    t_ops = col_steps * ops / F64_OPS_PER_S * 1e3
    t_bytes = col_steps * K * 8 / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (
        t_bytes, "bytes")
    say("  %d models, %d columns, %d evaluations, %d column-steps x %d f64 "
        "operations: bound %.4f ms (%s); kernel %.3f ms first, %.3f ms "
        "warm; plain %.1f ms on the card; host bisection %.1f ms"
        % (len(counts), int(M.sum()), int(steps.sum()), col_steps, ops,
           b_ms, b_by, ms, t_ms, plain_ms, host_ms))
    result["effn"] = dict(models=len(counts), columns=int(M.sum()),
                          evaluations=int(steps.sum()),
                          column_steps=col_steps, ops_per_column=ops,
                          ms=t_ms, ms_first=ms, plain_ms=plain_ms,
                          host_ms=host_ms, bound_ms=b_ms, bound_by=b_by,
                          differ=differ + differ_host, max_minf_diff=dminf,
                          min_margin=float(minf.min()))
    say(json.dumps({"effn": result["effn"]}))


def mesh_cards():
    """The cards of phase 4m: every visible card, or on a one-card host
    cuda:0 twice (the split, the per-card launches and the gather still
    run); and whether it is the latter."""
    import torch
    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(n)], False
    return [torch.device("cuda", 0)] * 2, True


def bank_on(bt, d):
    """bt's tables on card d (bt itself where they lie there)."""
    from witch_tpu_torch.device import BankTensors
    if bt.device == d:
        return bt
    return BankTensors(em=bt.em.to(d), trans=bt.trans.to(d), M=bt.M,
                       pad_code=bt.pad_code)


def phase_mesh(tmp, calls, bits_single, result):
    """4m: the data mesh (parallel/mesh.py). (a) dna1k's two banks, the
    forward calls phase 4 made, scored over the mesh: np.array_equal to
    the single-card bits phase 4 got, each card's kernel ms, the mesh's
    wall against one card's on the same call; (b) amino500 end to end
    with the mesh formed (WITCH_TPU_NO_MESH unset, the mesh's cards as the
    visible ones): 600/600 rows, the mesh logged, one forward launch a
    bank a card, outputs byte-identical to phase 3's."""
    import numpy as np
    import witch_tpu_torch.parallel.mesh as mesh
    from witch_tpu_torch.config import Configs
    from witch_tpu_torch.ops.forward import forward_bits

    cards, twice = mesh_cards()
    say("== phase 4m: the data mesh over %s" % ", ".join(map(str, cards)))
    if twice:
        say("  one card visible: the mesh is formed over cuda:0 twice, so "
            "that the split, the per-card launches and the gather run")
    check(len(calls) == 2 and len(bits_single) == 2,
          "4m: phase 4's two forward calls recorded")
    r = dict(cards=[str(d) for d in cards], one_card_twice=twice, banks=[])
    for (bt, codes, lens), ref in zip(calls, bits_single):
        bts = [bank_on(bt, d) for d in cards]
        mesh.sharded_forward_bits(bts, codes, lens)         # warm-up
        t0 = time.time()
        got, ms = mesh.sharded_forward_bits(bts, codes, lens)
        wall = time.time() - t0
        t0 = time.time()
        one = forward_bits(bt, codes, lens)
        wall1 = time.time() - t0
        check(np.array_equal(got, ref) and np.array_equal(one, ref),
              "4m: dna1k bank Mp=%d H=%d, %d queries over %d cards: bits "
              "np.array_equal to phase 4's single-card bits"
              % (bt.Mp, bt.H, len(lens), len(cards)))
        say("  kernel ms by card: %s; mesh call %.3f s, one card %.3f s"
            % (", ".join("%s %.2f" % (d, m) for d, m in zip(cards, ms)),
               wall, wall1))
        r["banks"].append(dict(Mp=bt.Mp, H=bt.H, queries=len(lens),
                               kernel_ms_by_card=ms, mesh_s=wall,
                               one_card_s=wall1))
    say("== phase 4m(b): amino500 end to end with the mesh")
    orig, aligner = mesh.visible_cards, list(REC_ALIGNER)
    mesh.visible_cards = lambda: list(cards)
    del os.environ["WITCH_TPU_NO_MESH"]
    try:
        outdir = os.path.join(tmp, "amino500_mesh")
        launches = run_amino(outdir, [], "amino500 mesh")
    finally:
        # the later phases read phase 4's aligner, not this run's
        os.environ["WITCH_TPU_NO_MESH"] = "1"
        mesh.visible_cards = orig
        REC_ALIGNER[:] = aligner
    logged = [ln for ln in open(os.path.join(outdir, "log.txt"))
              if "Scoring on %d-device data mesh" % len(cards) in ln]
    fwd = [ln.split("\t", 1)[-1].strip() for ln in open(os.path.join(
        outdir, "runtime_breakdown.txt")) if "device Forward" in ln]
    check(logged and Configs.scoring_cards == [str(d) for d in cards]
          and fwd and all("on %d cards" % len(cards) in ln for ln in fwd),
          "amino500 mesh: 'Scoring on %d-device data mesh' logged, every "
          "bank scored on the %d cards: %s" % (len(cards), len(cards), fwd))
    check(launches["forward"] == len(fwd) * len(cards),
          "amino500 mesh: %d forward launches, one a bank (%d) a card (%d)"
          % (launches["forward"], len(fwd), len(cards)))
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        check(open(os.path.join(outdir, f), "rb").read() == open(
            os.path.join(tmp, "amino500", f), "rb").read(),
            "amino500 mesh: %s byte-identical to phase 3's" % f)
    say("  amino500 wall: mesh %.2f s, phase 3 %.2f s"
        % (WALL["amino500 mesh"], WALL["amino500"]))
    r["amino500_forward_lines"] = fwd
    result["mesh"] = r
    return launches


def dna1k_vs_jax(rec, data, masked, ignored):
    prescore_vs_jax(rec, os.path.join(data, "queries.fasta"), masked,
                    ignored, ("ref_dna1k.queries.masked.fasta.gz",
                              DNA1K_JAX_MIN), "dna1k", JAX_DNA1K_IGNORED)


def prescore_vs_jax(rec, qpath, masked, ignored, golden, label,
                    jax_ignored=()):
    """A scenario-D run's query rows (the queries of qpath) against the
    JAX package's (golden: (file under tests/golden/, the least count of
    equal rows); made on the CPU, committed in tests/golden/). For each
    differing row, the two pre-score rankings of the query's top models:
    the port's f32 device pre-scores and the reference CPU path's native
    ones (forward_targets_simd, as witch_tpu/pipeline.py:232-267 calls
    it), and the gap between them. Returns the count of equal rows."""
    import numpy as np
    from witch_tpu_torch.config import Configs
    from witch_tpu_torch.hmm.profile import configure, null1_score
    from witch_tpu_torch.io.fasta import read_fasta
    from witch_tpu_torch.native import _domaindef
    from witch_tpu_torch.pipeline import _native_args

    with gzip.open(os.path.join(GOLD, golden[0]), "rt") as f:
        ref = dict(read_fasta(f))
    queries = list(read_fasta(qpath))
    same = [n for n, _ in queries if masked.get(n) == ref.get(n)]
    differ = [q for q, (n, _) in enumerate(queries)
              if masked.get(n) != ref.get(n)]
    say("  %s vs the JAX package's rows: %d/%d query rows equal; "
        "ignored here %d (JAX: %d)" % (label, len(same), len(queries),
                                       len(ignored), len(jax_ignored)))
    ens, indices, banks = rec.dgate[-1]
    H = len(indices)
    col_of = {int(idx): j for j, idx in enumerate(indices)}
    pre = np.zeros((len(queries), H))
    for b, bits in zip(banks, rec.fwd_bits):
        for j, idx in enumerate(b.hmm_indices):
            pre[:, col_of[int(idx)]] = bits[:, j]
    size = np.log2([ens.cores[int(i)].nseq for i in indices])
    top_n = min(H, int(Configs.num_hmms) + 4)      # the gate's NEAR depth
    qcodes = rec.gate[-1][0][3]
    args = {}
    for q in differ[:DNA1K_DIAG]:
        name, seq = queries[q]
        codes = [np.ascontiguousarray(qcodes[q], np.int32)]
        if len(codes[0]) != len(seq):
            raise AssertionError("%s: query %d of the gate is not %s"
                                 % (label, q, name))
        nat = np.zeros(H)
        for j in range(H):
            if j not in args:
                args[j] = _native_args(configure(
                    ens.cores[int(indices[j])], multihit=True))
            f = float(np.asarray(_domaindef.forward_targets_simd(
                *args[j], codes, 1))[0])
            nat[j] = (f - null1_score(len(codes[0]))) / np.log(2.0)
        adj_p, adj_n = pre[q] + size, nat + size
        rp = np.argsort(-adj_p, kind="stable")[:top_n]
        rn = np.argsort(-adj_n, kind="stable")[:top_n]
        first = next((r for r in range(top_n) if rp[r] != rn[r]), None)
        gap = ""
        if first is not None:
            a, b = rp[first], rn[first]
            gap = ("first differing rank %d: device ranks model %d over %d "
                   "by %.3g bits, native ranks %d over %d by %.3g bits"
                   % (first, indices[a], indices[b], adj_p[a] - adj_p[b],
                      indices[b], indices[a], adj_n[b] - adj_n[a]))
        say("  row %s differs: device top %s | native top %s | %s max "
            "|dpre| %.3g bits over the top models"
            % (name, [int(indices[j]) for j in rp],
               [int(indices[j]) for j in rn],
               gap or "rankings equal;",
               float(np.abs(pre[q, rp] - nat[rp]).max())))
    check(len(same) >= golden[1], "%s: %d/%d query rows equal the "
          "JAX package's (at least %d, the count of the first chip run)"
          % (label, len(same), len(queries), golden[1]))
    return len(same)


def phase_dna_golden(tmp):
    """The reference WITCH's DNA example (scenario D, 500 queries) against
    its oracle, as tests/test_golden.py's full tier compares it, when the
    example data is on this host."""
    import re
    from witch_tpu_torch.io.fasta import read_fasta

    say("== phase 4g: DNA golden (reference example data)")
    with open(os.path.join(ROOT, "tests", "test_golden.py")) as f:
        data = re.search(r'^DATA = "([^"]+)"', f.read(), re.M).group(1)
    if not os.path.isdir(data):
        say("  the example data (%s, as tests/test_golden.py names it) is "
            "absent on this host: phase skipped" % data)
        return None
    outdir = os.path.join(tmp, "dna_golden")
    out, dt, launches = run_cli([
        "-b", os.path.join(data, "backbone.aln.fasta.gz"),
        "-e", os.path.join(data, "backbone.tre"),
        "-q", os.path.join(data, "unaligned_frag.fasta"),
        "-d", outdir, "-o", "aligned.fasta"])
    say("  wall %.2f s; launches %s" % (dt, launches))

    def rows(fh):
        d, name = {}, None
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:].split()[0]
                d[name] = []
            elif name is not None:
                d[name].append(line)
        return {k: "".join(v) for k, v in d.items()}

    with gzip.open(os.path.join(GOLD, "ref_d.aligned.masked.fasta.gz"),
                   "rt") as f:
        gold = rows(f)
    with open(os.path.join(outdir, "aligned.masked.fasta")) as f:
        mine = rows(f)
    bad = [n for n in gold if mine.get(n) != gold[n]]
    check(len(gold) == 1000 and not bad, "DNA golden: %d/%d masked rows "
          "equal the reference oracle %s" % (len(gold) - len(bad), len(gold),
                                            bad[:5]))
    return launches


def _rows_near(mocc, ppB, ppE, lens, tol=1e-3):
    """[Q, H] bool on the device: some live row of the pair sits within
    tol of RT1 (mocc) or RT2 (mocc - dB, mocc - dE)."""
    import torch
    from witch_tpu_torch.hmm.flank_device import RT1, RT2
    W = mocc.shape[-1]
    ar = torch.arange(W, device=mocc.device)
    live = (ar >= 1) & (ar[None, None, :] <= lens[:, None, None])
    dB = torch.nn.functional.pad(ppB[..., :-1], (1, 0))
    near = ((mocc - RT1).abs() < tol) | ((mocc - dB - RT2).abs() < tol) \
        | ((mocc - ppE - RT2).abs() < tol)
    return (near & live).any(-1)


def _split_near(mocc, ppB, ppE, L, tol=1e-3):
    """True when a region of the pair has its split mass within tol of
    RT3 (host, one pair)."""
    import numpy as np
    from witch_tpu_torch.hmm.flank_device import RT3, find_regions_rows
    btot = np.cumsum(np.concatenate([[0.0], ppB[:L]]))
    etot = np.cumsum(np.concatenate([[0.0], ppE[1:L + 1]]))
    for (i, j) in find_regions_rows(mocc, ppB, ppE, L):
        ps = np.arange(i, j + 1)
        m = float(np.minimum(etot[ps] - etot[i - 1],
                             btot[j] - btot[ps - 1]).max())
        if abs(m - RT3) < tol:
            return True
    return False


def _decisions(rows, lens_np):
    """Three-way decisions [Q, H] from device rows (fwd, ppB, ppE, mocc)
    with the port's prefilter semantics."""
    import numpy as np
    import torch
    from witch_tpu_torch.hmm.flank_device import RT1, gate_prefilter
    _, ppB, ppE, mocc = rows
    Q, H = mocc.shape[:2]
    qi, hi = torch.nonzero((mocc >= RT1).any(-1), as_tuple=True)
    got = [x[qi, hi].cpu().numpy() for x in (mocc, ppB, ppE)]
    qi, hi = qi.cpu().numpy(), hi.cpu().numpy()
    d, _ = gate_prefilter(got[0], got[1], got[2], lens_np[qi])
    dec = np.full((Q, H), -1, np.int8)
    dec[qi, hi] = d
    return dec


def _compare_decisions(k, p, lens, ln):
    """Kernel (k) and plain (p) rows of one bank: (kernel decisions,
    plain decisions, [Q, H] near-threshold mask, the differing pairs,
    how many of them sit away from RT1, RT2 and RT3)."""
    import numpy as np
    dk, dp = _decisions(k, lens), _decisions(p, lens)
    near = (_rows_near(k[3], k[1], k[2], ln)
            | _rows_near(p[3], p[1], p[2], ln)).cpu().numpy()
    diff = np.argwhere(dk != dp)
    far = 0
    for q, h in diff:
        L = int(lens[q])
        if near[q, h]:
            continue
        rows = [[x[q, h].cpu().numpy() for x in (r[3], r[1], r[2])]
                for r in (k, p)]
        if not any(_split_near(*rw, L) for rw in rows):
            far += 1
    return dk, dp, near, diff, far


def phase_flank(banks_bench, codes, lens, dev, result):
    import numpy as np
    import torch
    from witch_tpu_torch.benchlib import native_args_from_bank
    from witch_tpu_torch.device import bank_to_torch
    from witch_tpu_torch.ops.flank import (flank_layout, flank_rows,
                                           flank_rows_ref)

    from witch_tpu_torch.native import _domaindef, set_trace_alphabet

    say("== phase 2d: flank kernel vs plain, bench_assets grid")
    c = torch.from_numpy(codes).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    err_fwd = err_rows = ms = plain_ms = 0.0
    n_pairs = n_near = n_diff = n_diff_far = n_kept = 0
    t_host = cells = nbytes = rbytes = 0.0
    layouts = {}
    dropped = []                 # (bank, row, query) the prefilter drops
    for b in banks_bench:
        bt = bank_to_torch(b, dev)
        QH = len(lens) * bt.H
        cells += grid_cells(bt, lens)
        nbytes += table_bytes(bt) + 4 * codes.size + 4 * QH * (
            1 + 3 * (codes.shape[1] + 1))
        rbytes += flank_rows_bytes(bt, codes, lens)
        layouts[bt.Mp] = flank_layout(bt.Mp)
        k = flank_rows(bt, c, ln)
        p, tp = timed_call(lambda: flank_rows_ref(bt, c, ln, elems=1 << 26))
        err_fwd = max(err_fwd, float((k[0] - p[0]).abs().max()))
        err_rows = max(err_rows, max(float((a - b_).abs().max())
                                     for a, b_ in zip(k[1:], p[1:])))
        ms += cuda_ms(lambda: flank_rows(bt, c, ln), 3)
        plain_ms += tp
        t0 = time.time()
        dk, dp, near, diff, far = _compare_decisions(k, p, lens, ln)
        t_host += time.time() - t0
        n_pairs += dk.size
        n_near += int(near.sum())
        n_diff += len(diff)
        n_diff_far += far
        n_kept += int((dk >= 0).sum())
        dropped += [(b, int(h), int(q)) for q, h in np.argwhere(dk < 0)]
        say("  bank H=%d Mp=%d (layout, G, npl, Mpad %s): |dfwd| %.3g "
            "nats, |drows| %.3g" % (bt.H, bt.Mp, layouts[bt.Mp], err_fwd,
                                    err_rows))
    say("  grid %d pairs: kernel %.2f ms, plain %.2f ms; %d pairs kept "
        "(decision >= 0); %d pairs with rows within 1e-3 of RT1/RT2; "
        "%d decisions differ, %d of them not near RT1/RT2/RT3 (host "
        "classification %.1f s)" % (n_pairs, ms, plain_ms, n_kept, n_near,
                                    n_diff, n_diff_far, t_host))
    check(all(x[0] == 0 for x in layouts.values()),
          "flank: the warp-per-pair kernel (layout 0) on both bench banks "
          "%s" % layouts)
    check(err_fwd <= 5e-3 and err_rows <= 2e-3,
          "flank kernel vs plain: |dfwd| %.3g <= 5e-3 nats, |drows| %.3g "
          "<= 2e-3" % (err_fwd, err_rows))
    check(n_diff_far == 0, "flank decisions equal plain except near the "
          "thresholds (%d differ, all near)" % n_diff)
    # pairs the prefilter drops have no region: native domain definition
    # reports none of a sample
    set_trace_alphabet("dna")
    rng = np.random.default_rng(5)
    pick = rng.choice(len(dropped), min(500, len(dropped)), replace=False)
    by_model = {}
    for t in pick:
        b, h, q = dropped[t]
        by_model.setdefault((id(b), h), (b, h, []))[2].append(q)
    reported = 0
    for b, h, qs in by_model.values():
        out = _domaindef.evaluate_targets(
            *native_args_from_bank(b, h),
            [np.ascontiguousarray(codes[q, :lens[q]]) for q in qs],
            42, 200, 1, 8)
        reported += int(((np.asarray(out[0]) > 0)
                         & (np.asarray(out[1]) > 0)).sum())
    check(len(pick) == min(500, len(dropped)) and reported == 0,
          "flank prefilter: %d of %d pairs dropped; %d sampled, %d "
          "reported by native evaluate_targets"
          % (len(dropped), n_pairs, len(pick), reported))
    result["flank"] = dict(max_abs_err=max(err_fwd, err_rows), ms=ms,
                           plain_ms=plain_ms, near_threshold=n_near,
                           decisions_differ=n_diff, cells=cells,
                           bytes=nbytes, layouts=layouts,
                           rows_bytes_ms=rbytes / HBM_BYTES_PER_S * 1e3)


def phase_cluster(result):
    """The cluster meeting on the card (ops/cluster.py): ns a meeting, the
    barrier alone and with a DSMEM exchange of one record, at C = 2, 4 and
    8, one cluster and every co-resident one; and how many clusters of the
    OA and flank cluster instances the card holds at once
    (cudaOccupancyMaxActiveClusters) at each shape their layouts take."""
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.cluster import barrier_probe

    say("== phase 2h: the thread-block cluster meeting")
    rows = barrier_probe((2, 4, 8))
    for r in rows:
        say("  C %d (%d co-resident clusters of 256 threads): barrier %.0f "
            "ns (%.0f cycles), %.0f ns all at once; record exchange %.0f ns "
            "(%.0f cycles), %.0f ns all at once"
            % (r["C"], r["max_active_clusters"], r["barrier_one_ns"],
               r["barrier_one_cycles"], r["barrier_all_ns"],
               r["exchange_one_ns"], r["exchange_one_cycles"],
               r["exchange_all_ns"]))
    lib = _build.lib()
    active = {}
    for name, fn, shapes in (
            ("oa", lib.witch_oa_cluster_active,
             [(C, 8) for C in range(2, 9)] + [(5, 16), (8, 16)]),
            ("flank", lib.witch_flank_cluster_active,
             [(2, 16), (2, 24), (3, 24)])):
        for C, npl in shapes:
            active["%s C%d npl%d" % (name, C, npl)] = fn(C, npl)
    say("  clusters resident at once: %s" % active)
    check(all(r["max_active_clusters"] > 0 for r in rows)
          and all(v > 0 for v in active.values()),
          "every cluster shape fits on the card (at least one co-resident)")
    result["cluster"] = dict(probe=rows, active=active)


def _wide_problem(seed=17):
    """A bank of one 8,000-state and one 16,384-state DNA model (WIDE_M),
    and query fragments of each model's consensus."""
    import numpy as np
    from witch_tpu_torch.core.alphabet import DNA
    from witch_tpu_torch.hmm.bank import build_banks
    from witch_tpu_torch.hmm.build import build_hmm, quantize_like_text
    rng = np.random.default_rng(seed)
    cores, queries = [], []
    for M in WIDE_M:
        base = rng.integers(0, 4, M)
        rows = np.array([np.where(rng.random(M) < 0.1,
                                  rng.integers(0, 4, M), base)
                         for _ in range(6)], np.uint8)
        cores.append(quantize_like_text(build_hmm(rows, DNA, "dna")))
        qs = []
        for _ in range(12):
            a = int(rng.integers(0, M - 300))
            q = base[a:a + int(rng.integers(100, 300))].copy()
            mut = rng.random(len(q)) < 0.05
            q[mut] = rng.integers(0, 4, int(mut.sum()))
            qs.append(q.astype(np.int32))
        queries.append(qs)
    banks = build_banks(cores, indices=[0, 1], uniform=True, n_buckets=2)
    return cores, queries, banks


def phase_wide(rec, dev, result):
    import numpy as np
    from witch_tpu_torch.benchlib import native_args_from_bank
    from witch_tpu_torch.hmm.profile import configure
    from witch_tpu_torch.native import _domaindef, set_trace_alphabet
    import witch_tpu_torch.pipeline as pl
    from witch_tpu_torch.device import bank_to_torch

    say("== phase 2e: oa, flank, forward and null2 on wide models (M 8,000 "
        "and 16,384)")
    t0 = time.time()
    cores, queries, banks = _wide_problem()
    set_trace_alphabet("dna")
    say("  models built in %.2f s; banks Mp %s" % (
        time.time() - t0, [bank_to_torch(b, dev).Mp for b in banks]))
    bank_row = {int(idx): (bi, r) for bi, b in enumerate(banks)
                for r, idx in enumerate(b.hmm_indices)}
    banks_t = [bank_to_torch(b, dev) for b in banks]
    # oa: kernel vs plain vs native
    import torch
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.oa import oa_nats, pack_pairs
    bad_p = bad_n = 0
    dmax = ms = plain_ms = ms_first = 0.0
    mps = []
    for j, qs in enumerate(queries):
        bi, r = bank_row[j]
        b = banks[bi]
        cols, mg, ok, bad, dm, t_k, t_p = oa_compare(
            banks_t[bi], [(r, q) for q in qs], 300, "wide model %d (Mp %d)"
            % (j, banks_t[bi].Mp))
        k0 = _build.KERNEL_MS["oa"]
        oa_nats(banks_t[bi], *pack_pairs(banks_t[bi], [(r, q) for q in qs]),
                Ldmax=300, first_version=True)
        torch.cuda.synchronize()
        t_f = _build.KERNEL_MS["oa"] - k0
        say("    the first version on the same pairs: %.2f ms" % t_f)
        a = native_args_from_bank(b, r)
        d = [np.ascontiguousarray(np.isfinite(x).astype(np.uint8))
             for x in a[1:]]
        for t, q in enumerate(qs):
            ref = np.asarray(_domaindef.posterior_oa_pair(
                *a, q, len(q), 0, *d))[:len(q)]
            if mg[t] >= OA_GUARD and ok[t] and not np.array_equal(cols[t],
                                                                   ref):
                bad_n += 1
        bad_p += bad
        dmax = max(dmax, dm)
        ms, plain_ms, ms_first = t_k, t_p, t_f   # the widest model's
        mps.append(banks_t[bi].Mp)
    from witch_tpu_torch.ops.oa import oa_layout
    check(bad_p == 0 and bad_n == 0 and dmax <= 1e-4
          and all(oa_layout(m)[0] == 1 for m in mps),
          "oa wide (the cluster instance, layout 1 at Mp %s): %d pairs, "
          "above-guard mismatches vs plain %d, vs native %d; finite margins "
          "within %.3g <= 1e-4 of plain"
          % (mps, sum(map(len, queries)), bad_p, bad_n, dmax))
    # forward's second layout keeps 3 rows in shared memory (197 KB at Mp
    # 16,416); flank's cluster instance a slice of the transitions a CTA
    from witch_tpu_torch.ops.flank import (flank_layout, flank_rows,
                                           flank_rows_ref)
    from witch_tpu_torch.ops.forward import LN2, forward_nats, \
        forward_nats_ref
    qall = [q for qs in queries for q in qs]
    cm = np.zeros((len(qall), max(map(len, qall))), np.int32)
    for i, q in enumerate(qall):
        cm[i, :len(q)] = q
    c = torch.from_numpy(cm).to(dev)
    ln = torch.from_numpy(np.array([len(q) for q in qall], np.int32)).to(dev)
    e_fw = e_ff = e_fr = fl_ms = fl_first = fl_plain = 0.0
    for bt in banks_t:
        e_fw = max(e_fw, float(((forward_nats(bt, c, ln)
                                 - forward_nats_ref(bt, c, ln)).abs()
                                / LN2).max()))
        k = flank_rows(bt, c, ln)
        torch.cuda.synchronize()
        t0 = time.time()
        p = flank_rows_ref(bt, c, ln)
        torch.cuda.synchronize()
        fl_plain += (time.time() - t0) * 1e3
        e_ff = max(e_ff, float((k[0] - p[0]).abs().max()))
        e_fr = max(e_fr, max(float((a - b_).abs().max())
                             for a, b_ in zip(k[1:], p[1:])))
        for fv in (False, True):
            k0 = _build.KERNEL_MS["flank"]
            flank_rows(bt, c, ln, first_version=fv)
            torch.cuda.synchronize()
            t = _build.KERNEL_MS["flank"] - k0
            if fv:
                fl_first += t
            else:
                fl_ms += t
    say("  flank on the %d queries of both models: kernel %.2f ms, the first "
        "version %.2f ms" % (len(qall), fl_ms, fl_first))
    check(e_fw <= 1e-3 and e_ff <= 5e-3 and e_fr <= 2e-3
          and all(flank_layout(bt.Mp)[0] == 1 for bt in banks_t),
          "forward and flank (its cluster instance, layout 1) at Mp %s vs "
          "plain: |dbits| %.3g <= 1e-3, flank |dfwd| %.3g <= 5e-3 nats, "
          "|drows| %.3g <= 2e-3" % (mps, e_fw, e_ff, e_fr))
    result["oa_wide"] = dict(max_abs_err=dmax, ms=ms, plain_ms=plain_ms,
                             Mp=max(mps), ms_first_version=ms_first)
    result["flank_wide"] = dict(max_abs_err=max(e_ff, e_fr), ms=fl_ms,
                                ms_first_version=fl_first,
                                plain_ms=fl_plain)
    # null2: the port's device gate on these pairs, replayed by phase_null2
    rec.clear()
    qcodes = [q for qs in queries for q in qs]
    by_j, flank, allargs = {}, {}, {}
    for j in range(len(cores)):
        allargs[j] = pl._native_args(configure(cores[j], multihit=True))
        by_j[j] = list(range(len(qcodes)))
        _, mo, pb, pe = _domaindef.flank_targets_simd(
            *allargs[j], [np.ascontiguousarray(q) for q in qcodes], 8)
        flank[j] = (mo, pb, pe)
    pl.evaluate_gate_device(banks_t, bank_row, allargs, qcodes, by_j, flank,
                            nthreads=8)
    phase_null2(rec, dev, result, "2e: null2 kernel vs plain, wide-model "
                "gate envelopes", "null2_wide")


def _query_rows_ok(outdir, qpath):
    """(n placed with their residues, n ignored, names neither)."""
    from witch_tpu_torch.io.fasta import read_fasta
    rows = read_fasta_dict(os.path.join(outdir, "aligned.fasta"))
    ign_p = os.path.join(outdir, "ignored_queries.fasta")
    ignored = set(read_fasta_dict(ign_p)) if os.path.exists(ign_p) else set()
    placed, bad = 0, []
    for n, s in read_fasta(qpath):
        if n in rows and rows[n].replace("-", "").upper() == s.upper():
            placed += 1
        elif n not in ignored:
            bad.append(n)
    return placed, len(ignored), bad


def full_search_replay(rec, dev, label, need_drops, layout=0, n_drop=500,
                       n_kept=300, first=False):
    """Checks of the latest --full-search-results run from what the
    Recorder kept: the path's flank inputs replayed through the kernel
    and its plain version (2d bounds; decisions equal the path's, and
    plain's away from the thresholds), every width on `layout`; the rows
    copied to the host are the kept pairs' rows; n_drop sampled dropped
    pairs unreported by native evaluate_targets; n_kept sampled kept
    pairs equal between native domain definition on the copied rows (as
    the path calls it) and on its own f64 rows. `first`: the first
    version's ms on the same calls too (and its rows within the same
    bounds of plain). Returns the kernel and plain times on the path's
    grid."""
    import numpy as np
    import torch
    from witch_tpu_torch.hmm.profile import configure
    from witch_tpu_torch.native import _domaindef
    from witch_tpu_torch.ops.flank import (flank_layout, flank_rows,
                                           flank_rows_ref)
    from witch_tpu_torch.pipeline import _native_args

    ens, indices, qcodes, drop = rec.full[-1]
    banks_t, bank_cols, codes, lens, dec, rows = rec.grid[-1]
    check(np.array_equal(drop, dec < 0), "%s: the pipeline drops exactly "
          "the prefilter's decision -1 pairs" % label)
    c = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    Q, H = dec.shape
    dec_k = np.full((Q, H), -1, np.int8)
    near_j = np.zeros((Q, H), bool)
    plain_rows = {}
    err_fwd = err_rows = ms = plain_ms = cells = nbytes = rbytes = 0.0
    ms_first = err_first = 0.0
    n_diff = n_far = 0
    layouts = {bt.Mp: flank_layout(bt.Mp) for bt in banks_t}
    for bt, cols in zip(banks_t, bank_cols):
        cells += grid_cells(bt, lens)
        nbytes += table_bytes(bt) + 4 * np.asarray(codes).size \
            + 4 * len(lens) * bt.H * (1 + 3 * (np.asarray(codes).shape[1] + 1))
        rbytes += flank_rows_bytes(bt, codes, lens)
        k = flank_rows(bt, c, ln)
        p, tp = timed_call(lambda: flank_rows_ref(bt, c, ln, elems=1 << 26))
        err_fwd = max(err_fwd, float((k[0] - p[0]).abs().max()))
        err_rows = max(err_rows, max(float((a - b_).abs().max())
                                     for a, b_ in zip(k[1:], p[1:])))
        ms += cuda_ms(lambda: flank_rows(bt, c, ln), 3)
        plain_ms += tp
        if first:
            from witch_tpu_torch import _build
            k0 = _build.KERNEL_MS["flank"]
            f = flank_rows(bt, c, ln, first_version=True)
            torch.cuda.synchronize()
            ms_first += _build.KERNEL_MS["flank"] - k0
            err_first = max(err_first,
                            float((f[0] - p[0]).abs().max()) / 5e-3,
                            max(float((a - b_).abs().max()) / 2e-3
                                for a, b_ in zip(f[1:], p[1:])))
            del f
        dk, dp, near, diff, far = _compare_decisions(k, p, lens, ln)
        n_diff += len(diff)
        n_far += far
        for r, j in enumerate(cols):
            dec_k[:, j] = dk[:, r]
            near_j[:, j] = near[:, r]
            if (dec[:, j] >= 0).any():
                plain_rows[j] = [x[:, r].cpu().numpy()
                                 for x in (p[3], p[1], p[2])]
        del k, p
    b_ms, b_by = bound_ms("flank", cells, nbytes)
    rows_ms = rbytes / HBM_BYTES_PER_S * 1e3
    say("  %d pairs, layouts (layout, G, npl, Mpad) by width %s: kernel "
        "%.2f ms, plain %.2f ms; bound %.3f ms (%s), outputs and stored "
        "specials %.3f ms; %d pairs with rows within 1e-3 of RT1/RT2; %d "
        "decisions differ from plain, %d of them not near RT1/RT2/RT3"
        % (Q * H, layouts, ms, plain_ms, b_ms, b_by, rows_ms,
           int(near_j.sum()), n_diff, n_far))
    check(all(x[0] == layout for x in layouts.values()),
          "%s: the %s flank kernel (layout %d) at every width"
          % (label, ("warp-per-pair", "cluster")[layout], layout))
    if first:
        say("  first version on the same calls: %.2f ms (its worst row "
            "error %.3g of the bounds below)" % (ms_first, err_first))
        check(err_first <= 1.0 and ms < ms_first, "%s: the kernel (%.2f "
              "ms) faster than the first version (%.2f ms) on the same "
              "calls" % (label, ms, ms_first))
    check(err_fwd <= 5e-3 and err_rows <= 2e-3,
          "%s: flank kernel vs plain on the path's inputs: |dfwd| %.3g <= "
          "5e-3 nats, |drows| %.3g <= 2e-3" % (label, err_fwd, err_rows))
    check(np.array_equal(dec, dec_k) and n_far == 0,
          "%s: the prefilter's decisions equal the replayed kernel's, and "
          "plain's except near the thresholds (%d differ, all near)"
          % (label, n_diff))
    worst, n_rows = 0.0, 0
    for j, (qs, mo, pb, pe) in rows.items():
        if not np.array_equal(qs, np.flatnonzero(dec[:, j] >= 0)):
            worst = float("inf")
            break
        for got, ref in zip((mo, pb, pe), plain_rows[j]):
            worst = max(worst, float(np.abs(got - ref[qs]).max()))
        n_rows += len(qs)
    check(n_rows == int((dec >= 0).sum()) and worst <= 2e-3,
          "%s: the %d copied row sets are the kept pairs' rows, within "
          "%.3g <= 2e-3 of plain" % (label, n_rows, worst))

    args_of = {}

    def args(j):
        if j not in args_of:
            args_of[j] = _native_args(configure(
                ens.cores[int(indices[j])], multihit=True))
        return args_of[j]

    rng = np.random.default_rng(3)
    dq, dj = np.nonzero(dec < 0)
    say("  the prefilter dropped %d of %d pairs" % (len(dq), dec.size))
    if need_drops:
        check(len(dq) > 0, "%s: the prefilter dropped pairs" % label)
    pick = rng.choice(len(dq), min(n_drop, len(dq)), replace=False)
    reported = 0
    for j in np.unique(dj[pick]):
        qs = dq[pick][dj[pick] == j]
        out = _domaindef.evaluate_targets(
            *args(int(j)), [np.ascontiguousarray(qcodes[q], np.int32)
                            for q in qs], 42, 200, 1, 8)
        reported += int(((np.asarray(out[0]) > 0)
                         & (np.asarray(out[1]) > 0)).sum())
    check(len(pick) == min(n_drop, len(dq)) and reported == 0,
          "%s: %d dropped pairs sampled, %d reported by native "
          "evaluate_targets" % (label, len(pick), reported))

    kq, kj = np.nonzero(dec >= 0)
    pick = rng.choice(len(kq), min(n_kept, len(kq)), replace=False)
    nbad = n_cmp = n_near = 0
    dsb = dse = dss = 0.0
    for j in np.unique(kj[pick]):
        qs = np.sort(kq[pick][kj[pick] == j])
        pos = np.searchsorted(rows[j][0], qs)
        sub = [np.ascontiguousarray(x[pos]) for x in rows[j][1:]]
        cl = [np.ascontiguousarray(qcodes[q], np.int32) for q in qs]
        got = _domaindef.evaluate_targets_rows(*args(int(j)), cl, 42, 200,
                                               1, 1, *sub, 8)
        nat = _domaindef.evaluate_targets(*args(int(j)), cl, 42, 200, 1, 8)
        for t, q in enumerate(qs):
            if near_j[q, j] or _split_near(sub[0][t], sub[1][t],
                                           sub[2][t], int(lens[q])):
                n_near += 1
                continue
            n_cmp += 1
            nbad += int(any(int(got[a][t]) != int(nat[a][t])
                            for a in (0, 1, 6)))
            dsb = max(dsb, abs(float(got[2][t]) - float(nat[2][t])))
            dse = max(dse, abs(float(got[4][t]) - float(nat[4][t])))
            dss = max(dss, abs(float(got[5][t]) - float(nat[5][t])))
    say("  %d sampled kept pairs (%d near a threshold, skipped): integer "
        "mismatches %d, |dsbias| %.3g, |dsenv| %.3g, |dsbsum| %.3g"
        % (len(pick), n_near, nbad, dsb, dse, dss))
    check(n_cmp > 0 and nbad == 0 and dsb < 2e-3 and dse < 2e-3
          and dss < 5e-3, "%s: native domain definition on the device rows "
          "equals native evaluate_targets on %d kept pairs" % (label, n_cmp))
    out = dict(max_abs_err=max(err_fwd, err_rows), ms=ms,
               plain_ms=plain_ms, pairs=Q * H, dropped=len(dq),
               bound_ms=b_ms, bound_by=b_by, rows_bytes_ms=rows_ms,
               layouts=layouts)
    if first:
        out["ms_first_version"] = ms_first
    return out


def phase_full_search(tmp, rec, dev, result):
    say("== phase 3b: amino500 with --full-search-results 1")
    rec.clear()
    outdir = os.path.join(tmp, "amino500_full")
    launches = run_amino(outdir, ["--full-search-results", "1"],
                         "amino500 full search")
    check(launches["flank"] > 0 and launches["forward"] > 0
          and launches["oa"] > 0,
          "full search: forward, flank and oa kernels launched %s"
          % launches)
    # every amino500 pair keeps a region: dropped pairs are checked on
    # the DNA grid of phase 4c
    result["flank_full_search"] = full_search_replay(
        rec, dev, "amino500 full search", need_drops=False)
    return launches


def phase_full_search_dna(tmp, rec, dev, result):
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta

    say("== phase 4c: dna1k backbone, %d queries, --full-search-results 1"
        % DNA_FULL)
    data = os.path.join(tmp, "dna1k")
    qpath = os.path.join(tmp, "dna1k_full.queries.fasta")
    write_fasta(list(read_fasta(os.path.join(data, "queries.fasta")))
                [:DNA_FULL], qpath)
    outdir = os.path.join(tmp, "dna1k_full")
    rec.clear()
    out, dt, launches = run_cli([
        "-b", os.path.join(data, "backbone.aln.fasta.gz"),
        "-e", os.path.join(data, "backbone.tre"),
        "-q", qpath, "-d", outdir, "-o", "aligned.fasta",
        "--full-search-results", "1"])
    print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    check(launches["flank"] > 0 and launches["forward"] > 0
          and launches["oa"] > 0,
          "dna1k full search: forward, flank and oa kernels launched %s"
          % launches)
    placed, n_ign, bad = _query_rows_ok(outdir, qpath)
    check(not bad, "dna1k full search: every query placed with its "
          "residues (%d) or ignored (%d)" % (placed, n_ign))
    result["flank_full_search_dna"] = full_search_replay(
        rec, dev, "dna1k full search", need_drops=True)
    return launches


def dnawide_data(tmp):
    """phase 4w's data (DNAWIDE), generated once per run."""
    data = os.path.join(tmp, "dnawide")
    if not os.path.exists(os.path.join(data, "queries.fasta")):
        n, q, cols, seed = DNAWIDE
        t0 = time.time()
        subprocess.run([sys.executable, os.path.join(
            ROOT, "scripts", "make_scale_dataset.py"), "--n", str(n),
            "--queries", str(q), "--cols", str(cols), "--seed", str(seed),
            "--out", data], check=True, capture_output=True, timeout=300)
        say("  dataset generated in %.2f s" % (time.time() - t0))
    return data


def phase_dnawide(tmp, rec, dev, result):
    """dnawide scenario D through the CLI at the dataset's full width:
    every query placed or ignored, backbone rows intact, the forward, null2
    and oa kernels launched, each bank's Mp and each kernel's layout (OA on
    the cluster layout), the query rows against the JAX package's (at
    least DNAWIDE_JAX, the pre-score rankings of a differing row). A
    query's row depends on that query alone, so the first DNAWIDE_Q
    queries are held against the golden of all 100."""
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta
    from witch_tpu_torch.ops.flank import flank_layout
    from witch_tpu_torch.ops.forward import fwd_layout
    from witch_tpu_torch.ops.null2 import n2_layout
    from witch_tpu_torch.ops.oa import oa_layout

    say("== phase 4w: dnawide scenario D, %d x 7,110-column DNA backbone "
        "(make_scale_dataset.py --cols %d), its first %d queries"
        % (DNAWIDE[0], DNAWIDE[2], DNAWIDE_Q))
    data = dnawide_data(tmp)
    qpath = os.path.join(tmp, "dnawide.queries.fasta")
    write_fasta(list(read_fasta(os.path.join(data, "queries.fasta")))
                [:DNAWIDE_Q], qpath)
    outdir = os.path.join(tmp, "dnawide_out")
    rec.clear()
    out, dt, launches = run_cli([
        "-b", os.path.join(data, "backbone.aln.fasta.gz"),
        "-e", os.path.join(data, "backbone.tre"),
        "-q", qpath, "-d", outdir, "-o", "aligned.fasta"])
    print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    WALL["dnawide"] = dt
    placed, n_ign, bad = _query_rows_ok(outdir, qpath)
    check(not bad, "dnawide: every query placed with its residues (%d) or "
          "ignored (%d)" % (placed, n_ign))
    masked = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    bb = read_fasta_dict(os.path.join(data, "backbone.aln.fasta.gz"))
    badb = [n for n, s in bb.items() if masked.get(n) != s.upper()]
    check(not badb, "dnawide: %d/%d backbone rows equal the input"
          % (len(bb) - len(badb), len(bb)))
    check(all(launches[k] > 0 for k in ("forward", "null2", "oa")),
          "dnawide: forward, null2 and oa launched on the main path %s"
          % launches)
    score = sorted({bt.Mp for bt, _, _ in rec.fwd})
    align = sorted({rec.oa[0][0][bi].Mp for bi, _ in
                    rec.oa[0][1].values()})
    for Mp in sorted(set(score) | set(align)):
        say("  bank Mp %d (%s): forward %s, null2 %s, oa %s, flank %s"
            % (Mp, "+".join(x for x, ms in (("scoring", score),
                                             ("alignment", align))
                            if Mp in ms), fwd_layout(Mp), n2_layout(Mp),
               oa_layout(Mp), flank_layout(Mp)))
    check(align and all(oa_layout(m)[0] == 1 for m in align),
          "dnawide: OA on the cluster layout at every alignment bank %s"
          % align)
    ign_p = os.path.join(outdir, "ignored_queries.fasta")
    ignored = set(read_fasta_dict(ign_p)) if os.path.exists(ign_p) else set()
    result["rows_dnawide"] = prescore_vs_jax(rec, qpath, masked, ignored,
                                             DNAWIDE_JAX, "dnawide")
    return launches


def phase_full_search_dnawide(tmp, rec, dev, result):
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta

    say("== phase 4wc: dnawide backbone, %d queries, --full-search-results "
        "1" % DNAWIDE_FULL)
    data = dnawide_data(tmp)
    qpath = os.path.join(tmp, "dnawide_full.queries.fasta")
    write_fasta(list(read_fasta(os.path.join(data, "queries.fasta")))
                [:DNAWIDE_FULL], qpath)
    outdir = os.path.join(tmp, "dnawide_full")
    rec.clear()
    out, dt, launches = run_cli([
        "-b", os.path.join(data, "backbone.aln.fasta.gz"),
        "-e", os.path.join(data, "backbone.tre"),
        "-q", qpath, "-d", outdir, "-o", "aligned.fasta",
        "--full-search-results", "1"])
    print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    WALL["dnawide_full"] = dt
    check(launches["flank"] > 0 and launches["forward"] > 0
          and launches["oa"] > 0,
          "dnawide full search: forward, flank and oa kernels launched %s"
          % launches)
    placed, n_ign, bad = _query_rows_ok(outdir, qpath)
    check(not bad, "dnawide full search: every query placed with its "
          "residues (%d) or ignored (%d)" % (placed, n_ign))
    result["flank_full_search_dnawide"] = full_search_replay(
        rec, dev, "dnawide full search", need_drops=False, layout=1,
        n_drop=16, n_kept=16, first=True)
    return launches


def phase_old_witch(tmp, rec):
    from witch_tpu_torch.aligner import validate_oa

    say("== phase 3c: amino500 with -m old-witch")
    rec.clear()
    outdir = os.path.join(tmp, "amino500_ow")
    launches = run_amino(outdir, ["-m", "old-witch"], "amino500 old-witch",
                         oracle=False)
    qpath = os.path.join(GOLD, AMINO[0] + ".queries.fasta")
    placed, n_ign, bad = _query_rows_ok(outdir, qpath)
    check(not bad, "old-witch: every query placed with its residues (%d) "
          "or ignored (%d)" % (placed, n_ign))
    from witch_tpu_torch.io.fasta import read_fasta
    rows_vs_jax("old-witch", read_fasta_dict(os.path.join(
        outdir, "aligned.masked.fasta")), AMINO500_OW_JAX,
        [n for n, _ in read_fasta(qpath)])
    _, _, pairs, Ldmax = rec.oa[-1]
    v = validate_oa(REC_ALIGNER[0], pairs, Ldmax)
    check(v["above_guard"] == 0,
          "old-witch: all %d OA pairs equal native above the guard (%d "
          "mismatched, all below the guard; %d re-aligned)"
          % (v["n"], v["mismatched"], v["redo"]))
    return launches


def phase_scenario_c(tmp, rec):
    import numpy as np
    from witch_tpu_torch.tree_estimate import jc_distances

    from witch_tpu_torch.io.fasta import read_fasta, write_fasta

    data = os.path.join(tmp, "dna1k")
    qpath = os.path.join(tmp, "dna1k_c.queries.fasta")
    write_fasta(list(read_fasta(os.path.join(data, "queries.fasta")))
                [:DNA1K_C_Q], qpath)
    say("== phase 4b: scenario C, dna1k without -e (tree estimated), its "
        "first %d queries" % DNA1K_C_Q)
    outdir = os.path.join(tmp, "dna1k_c")
    rec.clear()
    out, dt, launches = run_cli([
        "-b", os.path.join(data, "backbone.aln.fasta.gz"),
        "-q", qpath, "-d", outdir, "-o", "aligned.fasta"])
    print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    aln, m, d = rec.counts[-1]
    K = aln.alphabet.K
    codes = aln.codes.astype(np.int64)
    canon = codes < K
    n, L = codes.shape
    onehot = np.zeros((n, L, K))
    r, c = np.nonzero(canon)
    onehot[r, c, codes[r, c]] = 1.0
    flat = onehot.reshape(n, L * K)
    mf = canon.astype(np.float64)
    m64, d64 = flat @ flat.T, mf @ mf.T
    check(np.array_equal(m, m64) and np.array_equal(d, d64)
          and np.array_equal(rec.dist[-1], jc_distances(m64, d64, K)),
          "scenario C: device identity counts and distances [%d x %d] "
          "equal numpy float64" % (n, n))
    placed, n_ign, bad = _query_rows_ok(outdir, qpath)
    check(not bad, "scenario C: every query placed with its residues (%d) "
          "or ignored (%d)" % (placed, n_ign))
    masked = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    bb = read_fasta_dict(os.path.join(data, "backbone.aln.fasta.gz"))
    badb = [k for k, s in bb.items() if masked.get(k) != s.upper()]
    check(not badb, "scenario C: %d/%d backbone rows equal the input"
          % (len(bb) - len(badb), len(bb)))
    rows_vs_jax("scenario C", masked, DNA1K_C_JAX,
                [n for n, _ in read_fasta(qpath)])
    check(all(launches[k] > 0 for k in ("forward", "null2", "oa")),
          "scenario C: forward, null2 and oa launched %s" % launches)
    return launches

# one query shard of amino500 through the pipeline on the card, its shard
# from WITCH_TPU_SHARD: prints whether it merged, its wall and launches
SHARD_RUN = r"""
import json, sys, time
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import torch
from witch_tpu_torch import _build
from witch_tpu_torch.cli import init_parser
from witch_tpu_torch.config import Configs, build_configs
from witch_tpu_torch.pipeline import main_alignment_process
build_configs(init_parser(), sys.argv[2:])
torch.set_num_threads(Configs.num_cpus)     # its share of the cores (-t)
t0 = time.time()
out = main_alignment_process()
print(json.dumps({"merged": out is not None, "wall_s": time.time() - t0,
                  "launches": _build.LAUNCHES}))
"""


def phase_sharded(tmp):
    """Query sharding on the card: (a) dna1k (phase 4's data) as two gloo
    ranks at once on the one card through tools/run_distributed.py, into
    one outdir; (b) amino500 as WITCH_TPU_SHARD 0/2 and 1/2 started at the
    same moment into one outdir (the file-staged gather). Returns the
    launches of every rank of both."""
    from witch_tpu_torch.io.fasta import read_fasta

    t_phase = time.time()
    say("== phase 4s(a): dna1k as two gloo ranks at once on the one card "
        "(witch_tpu_torch/tools/run_distributed.py)")
    data = os.path.join(tmp, "dna1k")
    ref = os.path.join(tmp, "dna1k_out", "aligned.masked.fasta")
    outdir = os.path.join(tmp, "dna1k_sharded")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "witch_tpu_torch", "tools",
                                      "run_distributed.py"),
         "-n", "2", "--device", "cuda", "--timeout", "400", "--compare", ref,
         "--", "-b", os.path.join(data, "backbone.aln.fasta.gz"),
         "-e", os.path.join(data, "backbone.tre"),
         "-q", os.path.join(data, "queries.fasta"),
         "-d", outdir, "-o", "aligned.fasta"], cwd=ROOT,
        capture_output=True, text=True, timeout=500)
    if r.returncode != 0:
        say(r.stdout[-3000:] + r.stderr[-6000:])
    check(r.returncode == 0, "dna1k sharded: the tool ran both ranks (rc %d)"
          % r.returncode)
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    ranks, summary = lines[:-1], lines[-1]
    total = {k: 0 for k in ranks[0]["launches"]}
    for x in ranks:
        say("  rank %d: wall %.2f s (phase 4, one process: %.2f s), gather "
            "%.3f s, merged %s, launches %s"
            % (x["rank"], x["wall_s"], WALL["dna1k"], x["gather_s"],
               x["merged"], x["launches"]))
        for ln in x["breakdown"]:
            say("    " + ln)
        for k, v in x["launches"].items():
            total[k] += v
    say("  tool wall (start of both ranks to the end of both) %.2f s"
        % summary["wall_s"])
    check(summary["merged_ranks"] == [0] and len(ranks) == 2,
          "dna1k sharded: exactly one rank merged (rank %s)"
          % summary["merged_ranks"])
    check(summary["identical"] is True, "dna1k sharded: merged "
          "aligned.masked.fasta byte-identical to phase 4's")
    check(all(x["launches"][k] > 0 for x in ranks
              for k in ("forward", "null2", "oa")),
          "dna1k sharded: forward, null2 and oa launched by each rank")
    masked = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    rows_vs_jax("dna1k sharded", masked,
                ("ref_dna1k.queries.masked.fasta.gz", DNA1K_JAX_MIN),
                [n for n, _ in read_fasta(os.path.join(data,
                                                       "queries.fasta"))])
    WALL["dna1k sharded"] = max(x["wall_s"] for x in ranks)

    say("== phase 4s(b): amino500 as WITCH_TPU_SHARD 0/2 and 1/2 started "
        "at once into one outdir (file-staged gather)")
    pre, n_rows = AMINO
    outdir = os.path.join(tmp, "amino500_sharded")
    env = dict(os.environ, WITCH_TPU_NO_DAEMON="1")
    env.pop("WITCH_TPU_SPEC_OA", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RUN, ROOT] + amino_argv(outdir) + [
            "-t", str(max(1, (os.cpu_count() or 2) // 2))],
        cwd=ROOT, env=dict(env, WITCH_TPU_SHARD="%d/2" % i),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (o, e) in enumerate(outs):
        if procs[i].returncode != 0:
            say("  shard %d/2 failed:\n%s" % (i, e[-4000:]))
    check(all(p.returncode == 0 for p in procs),
          "amino500 sharded: both shards ran (rc %s)"
          % [p.returncode for p in procs])
    res = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    for i, x in enumerate(res):
        say("  shard %d/2: wall %.2f s (phase 3, one process: %.2f s), "
            "merged %s, launches %s" % (i, x["wall_s"], WALL["amino500"],
                                        x["merged"], x["launches"]))
        for k, v in x["launches"].items():
            total[k] += v
    check(sum(x["merged"] for x in res) == 1,
          "amino500 sharded: exactly one process merged (shard %s)"
          % [i for i, x in enumerate(res) if x["merged"]])
    mine = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    with gzip.open(os.path.join(
            GOLD, pre + ".aligned.masked.fasta.gz"), "rt") as f:
        gold = dict(read_fasta(f))
    bad = [n for n in gold if mine.get(n) != gold[n]]
    check(len(gold) == n_rows and not bad,
          "amino500 sharded: %d/%d masked rows equal the oracle"
          % (len(gold) - len(bad), n_rows))
    same = [open(os.path.join(outdir, f), "rb").read() == open(os.path.join(
        tmp, "amino500", f), "rb").read()
        for f in ("aligned.fasta", "aligned.masked.fasta")]
    check(all(same), "amino500 sharded: aligned.fasta and "
          "aligned.masked.fasta byte-identical to phase 3's")
    say("  phase 4s: %.1f s; launches of every rank %s"
        % (time.time() - t_phase, total))
    return total


def scenario_a_input(tmp, spec=None):
    """Scenario A's -i input (made once): the ungapped full-length rows
    and the fragments of make_scale_dataset.py; spec (full-length,
    fragments, --cols or None, --seed) defaults to phase 5's SCEN_A, 300
    and 100 of --seed 20261016."""
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta
    n_full, n_frag, cols, seed = spec or SCEN_A[:2] + (None, 20261016)
    data = os.path.join(tmp, "scenA" if spec is None else
                        "scenA_%d_%d_%s_%d" % (n_full, n_frag, cols, seed))
    inp = os.path.join(data, "input.fasta")
    if os.path.exists(inp):
        return inp
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_scale_dataset.py"),
                    "--n", str(n_full), "--queries", str(n_frag), "--seed",
                    str(seed), "--out", data]
                   + (["--cols", str(cols)] if cols else []), check=True,
                   capture_output=True, timeout=300)
    recs = [(n, s.replace("-", "").upper()) for n, s in read_fasta(
        os.path.join(data, "backbone.aln.fasta.gz"))]
    recs += [(n, s.upper()) for n, s in read_fasta(
        os.path.join(data, "queries.fasta"))]
    write_fasta(recs, inp)
    return inp


def phase_scenario_a(tmp, rec, label="5: scenario A", out="scenA_out",
                     spec=None, backbone=SCEN_A[2], golden=SCEN_A_JAX):
    from witch_tpu_torch.io.fasta import read_fasta

    inp = scenario_a_input(tmp, spec)
    n_in = sum(1 for _ in read_fasta(inp))
    say("== phase %s, -i (%d sequences), --backbone-size %d"
        % (label, n_in, backbone))
    outdir = os.path.join(tmp, out)
    rec.clear()
    _, dt, launches = run_cli(["-i", inp, "-d", outdir, "-o",
                               "aligned.fasta", "--backbone-size",
                               str(backbone)])
    lines = print_breakdown(outdir)
    say("  wall %.2f s; launches %s" % (dt, launches))
    say("  " + " | ".join(ln.split("\t", 1)[-1].strip() for ln in lines
                          if "device gate" in ln))
    placed, n_ign, bad = _query_rows_ok(outdir, inp)
    check(not bad and placed + n_ign == n_in,
          "%s: all %d input sequences in the output with their "
          "residues (%d) or ignored (%d)" % (label, n_in, placed, n_ign))
    masked = read_fasta_dict(os.path.join(outdir, "aligned.masked.fasta"))
    widths = {len(v) for v in masked.values()}
    check(len(widths) == 1, "%s: %d masked rows flush (width %s)"
          % (label, len(masked), widths))
    check(all(launches[k] > 0 for k in ("forward", "null2", "oa")),
          "%s: forward, null2 and oa launched %s" % (label, launches))
    rows_vs_jax(label, masked, golden)
    WALL[out] = dt
    return launches


def phase_scenario_a_embed(tmp, rec):
    """Scenario A again on phase 5's input with WITCH_TPU_DEVICE_EMBED=1:
    phase 5's checks, and the pair-HMM kernel launched."""
    import witch_tpu_torch.ops.pairhmm as ph
    orig, seen = ph.pairhmm_layout, {}

    def layout(C, LB):
        seen[LB] = orig(C, LB)
        return seen[LB]

    os.environ["WITCH_TPU_DEVICE_EMBED"] = "1"
    ph.pairhmm_layout = layout
    try:
        launches = phase_scenario_a(
            tmp, rec, "5d: scenario A with WITCH_TPU_DEVICE_EMBED=1",
            "scenA_embed_out")
    finally:
        del os.environ["WITCH_TPU_DEVICE_EMBED"]
        ph.pairhmm_layout = orig
    check(launches["pairhmm"] > 0 and seen
          and all(v[0] == 0 for v in seen.values()),
          "scenario A with WITCH_TPU_DEVICE_EMBED=1: the pair-HMM kernel "
          "launched %d times, the register kernel at every width (LB: "
          "layout, CH, G %s)"
          % (launches["pairhmm"], seen))
    return launches


def _pairhmm_tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "witch_pairhmm_bench", os.path.join(
            ROOT, "witch_tpu_torch", "tools", "pairhmm_bench.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def phase_embed(tmp, dev, result):
    """The pair-HMM kernels on anchor embeddings of the device path
    (witch_tpu_torch/tools/pairhmm_bench.py's record_calls, time_calls
    and ptxas): nvcc -Xptxas -v of csrc/pairhmm.cu, no instance spilling;
    scenario A's 100 backbone sequences (phase 5's backbone, 2,400
    sequence-anchor pairs) through the kernel and through the plain
    version, E within 2e-4 (the bar of tests/test_pairhmm_forward.py),
    the register kernel at every width, the kernel's ms on the path's own
    calls beside the first version's on the same calls, plain's and the
    bound; then dna1k's data (phase 4's) at the default 1,000-sequence
    backbone, 24,000 pairs: the kernel's ms, launches, cells and bound,
    the first version's ms, and plain on its one launch (no warm-up),
    within 2e-4 a residue."""
    import numpy as np
    from witch_tpu_torch import _build
    from witch_tpu_torch.core.alphabet import ALPHABETS
    from witch_tpu_torch.io.fasta import read_fasta

    say("== phase 5c: pair-HMM anchor embeddings, kernel vs plain and the "
        "first version")
    tool = _pairhmm_tool()
    regs = tool.ptxas()
    for r in regs:
        say("  ptxas %s: %d registers, %d B stack, spill stores %d B, "
            "loads %d B; %d warps a SM" % (
                r["kernel"], r["registers"], r["stack"], r["spill_stores"],
                r["spill_loads"], r["warps_per_sm"]))
    from witch_tpu_torch.ops.pairhmm import PH_CH, PHW_CH
    check(len(regs) == len(PH_CH) + len(PHW_CH) + 1
          and not any(r["spill_stores"] or r["spill_loads"] for r in regs),
          "pairhmm: no spills in the %d kernel instances (register, wide "
          "and first version)" % len(regs))

    al = ALPHABETS["dna"]
    codes = [al.encode(x.replace("-", "").upper()) for _, x in read_fasta(
        os.path.join(tmp, "scenA_out", "backbone", "backbone.aln.fasta"))]
    n0, t0 = _build.LAUNCHES["pairhmm"], time.time()
    E_k, calls = tool.record_calls(codes, al, dev)
    n_k, wall = _build.LAUNCHES["pairhmm"] - n0, time.time() - t0
    E_p, _ = tool.record_calls(codes, al, dev, kernel=False)
    n, A = E_k.shape
    err = float(np.abs(E_k - E_p).max())
    check(np.isfinite(E_k).all() and n == len(codes) and err <= 2e-4,
          "pairhmm: anchor embedding [%d, %d] (%d pairs), kernel vs plain "
          "max |dE| %.3g <= 2e-4, %d launches, %.2f s"
          % (n, A, n * A, err, n_k, wall))
    r = tool.time_calls(calls, 3, first=True)
    check(all(v[0] == 0 for v in r["layouts"].values()),
          "pairhmm: the register kernel at every width of the path (LB: "
          "layout, CH, G %s)" % r["layouts"])
    b_ms, b_by = bound_ms("pairhmm", r["cells"], r["bytes"])
    check(abs(b_ms - r["bound_ms"]) <= 1e-9 * b_ms,
          "pairhmm: the tool's bound equals the script's")
    say("  %d launches at the path's shapes: kernel %.3f ms (the first "
        "version %.3f ms on the same calls), plain %.1f ms; max |d "
        "log-odds| %.3g nats vs plain, %.3g vs the first version; %.4g "
        "cells, bound %.4f ms (%s)"
        % (len(calls), r["ms"], r["ms_first_version"], r["plain_ms"],
           r["max_abs_err_logodds"], r["max_abs_diff_first_version"],
           r["cells"], b_ms, b_by))
    result["pairhmm"] = dict(
        max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
        cells=r["cells"], bytes=r["bytes"], pairs=n * A,
        max_abs_err_logodds=r["max_abs_err_logodds"],
        ms_first_version=r["ms_first_version"],
        max_abs_diff_first_version=r["max_abs_diff_first_version"],
        layouts=r["layouts"], ptxas=regs)

    t0 = time.time()
    codes, al = tool.backbone_codes(DNA1K_BACKBONE,
                                    data=os.path.join(tmp, "dna1k"))
    n0 = _build.LAUNCHES["pairhmm"]
    E_k, calls = tool.record_calls(codes, al, dev)
    n_k, wall = _build.LAUNCHES["pairhmm"] - n0, time.time() - t0
    n, A = E_k.shape
    r = tool.time_calls(calls, 3, first=True, plain_warm=False)
    b_ms, b_by = bound_ms("pairhmm", r["cells"], r["bytes"])
    check(np.isfinite(E_k).all() and n == DNA1K_BACKBONE
          and r["max_abs_err_per_residue"] <= 2e-4
          and all(v[0] == 0 for v in r["layouts"].values()),
          "pairhmm: dna1k's data at a %d-sequence backbone, embedding [%d, "
          "%d] (%d pairs) in %d launches (%.2f s with the host's part), "
          "the register kernel (%s), kernel vs plain max |d log-odds| "
          "%.3g nats, %.3g a residue <= 2e-4"
          % (DNA1K_BACKBONE, n, A, n * A, n_k, wall, r["layouts"],
             r["max_abs_err_logodds"], r["max_abs_err_per_residue"]))
    say("  24,000 pairs: kernel %.3f ms (the first version %.3f ms on the "
        "same calls, max |d log-odds| %.3g), plain %.1f ms; %.4g cells, "
        "bound %.4f ms (%s)"
        % (r["ms"], r["ms_first_version"], r["max_abs_diff_first_version"],
           r["plain_ms"], r["cells"], b_ms, b_by))
    result["pairhmm_dna1k_backbone"] = dict(
        max_abs_err=r["max_abs_err_per_residue"], ms=r["ms"],
        plain_ms=r["plain_ms"], cells=r["cells"], bound_ms=b_ms,
        bound_by=b_by, launches=n_k, pairs=n * A,
        ms_first_version=r["ms_first_version"],
        max_abs_diff_first_version=r["max_abs_diff_first_version"],
        layouts=r["layouts"])


def _wide_ctas(layouts, C=17):
    """{LB: CTAs a SM} of the wide layouts in a {LB: (layout, CH, G)}."""
    from witch_tpu_torch.ops.pairhmm import wide_ctas_per_sm
    return {lb: wide_ctas_per_sm(v[1], v[2], C) for lb, v in layouts.items()
            if v[0] == 2}


def phase_embed_wide(tmp, dev, result):
    """5w: dnawide's backbone embedding on the wide layout: the 2,400
    sequence-anchor pairs of DNAWIDE_EMBED backbone sequences of phase
    4w's data (~7,000 residues each) through the kernel; its ms beside
    the first version's on the same calls (once each, after a warm-up
    for the kernel), the wide instances' registers without spills (5c's
    ptxas), the layout and CTAs a SM at each width, the bound, and
    DNAWIDE_EMBED_PLAIN seeded pairs through kernel and plain within 2e-4
    nats a residue."""
    import numpy as np
    from witch_tpu_torch import _build

    say("== phase 5w: dnawide's backbone embedding (%d sequences) on the "
        "pair-HMM kernel's wide layout" % DNAWIDE_EMBED)
    tool = _pairhmm_tool()
    wide = [r for r in result["pairhmm"]["ptxas"]
            if r["kernel"].startswith("pairhmm_wide_kernel")]
    for r in wide:
        say("  ptxas %s: %d registers, spill stores %d B, loads %d B"
            % (r["kernel"], r["registers"], r["spill_stores"],
               r["spill_loads"]))
    from witch_tpu_torch.ops.pairhmm import PHW_CH
    check(len(wide) == len(PHW_CH) and not any(
        r["spill_stores"] or r["spill_loads"] for r in wide),
          "pairhmm: no spills in the %d wide instances" % len(wide))
    t0 = time.time()
    codes, al = tool.backbone_codes(DNAWIDE_EMBED, data=dnawide_data(tmp))
    n0 = _build.LAUNCHES["pairhmm"]
    E_k, calls = tool.record_calls(codes, al, dev)
    n_k, wall = _build.LAUNCHES["pairhmm"] - n0, time.time() - t0
    n, A = E_k.shape
    lens = [len(c) for c in codes]
    r = tool.time_calls(calls, 1, plain=False, first=True, first_warm=False)
    ctas = _wide_ctas({int(k): v for k, v in r["layouts"].items()})
    b_ms, b_by = bound_ms("pairhmm", r["cells"], r["bytes"])
    check(np.isfinite(E_k).all() and n == DNAWIDE_EMBED
          and all(v[0] == 2 for v in r["layouts"].values()),
          "pairhmm: dnawide embedding [%d, %d] (%d pairs of %d-%d "
          "residues) in %d launches (%.2f s with the host's part), the wide "
          "layout at every width (LB: layout, CH, G %s; CTAs a SM %s)"
          % (n, A, n * A, min(lens), max(lens), n_k, wall, r["layouts"],
             ctas))
    smi = smi_line()
    say("  %d pairs: kernel %.3f ms, the first version %.3f ms on the same "
        "calls (max |d log-odds| %.3g); %.4g cells, bound %.4f ms (%s); "
        "%s" % (n * A, r["ms"], r["ms_first_version"],
                r["max_abs_diff_first_version"], r["cells"], b_ms, b_by,
                smi))
    check(r["ms"] < r["ms_first_version"],
          "pairhmm: the wide layout faster than the first version on the "
          "same calls (%.3f < %.3f ms)" % (r["ms"], r["ms_first_version"]))
    sub = tool.subsample(calls, DNAWIDE_EMBED_PLAIN, seed=5)
    rs = tool.time_calls(sub, 1, plain=True, plain_warm=False)
    check(rs["max_abs_err_per_residue"] <= 2e-4,
          "pairhmm: %d seeded dnawide pairs, kernel vs plain max |d "
          "log-odds| %.3g nats, %.3g a residue <= 2e-4 (kernel %.3f ms, "
          "plain %.1f ms on them)"
          % (sum(len(c[1]) for c in sub), rs["max_abs_err_logodds"],
             rs["max_abs_err_per_residue"], rs["ms"], rs["plain_ms"]))
    result["pairhmm_dnawide_embed"] = dict(
        max_abs_err=rs["max_abs_err_per_residue"], ms=r["ms"],
        plain_ms=rs["plain_ms"], plain_pairs=sum(len(c[1]) for c in sub),
        ms_plain_pairs=rs["ms"], cells=r["cells"], bound_ms=b_ms,
        bound_by=b_by, launches=n_k, pairs=n * A,
        ms_first_version=r["ms_first_version"],
        max_abs_diff_first_version=r["max_abs_diff_first_version"],
        layouts=r["layouts"], ctas_per_sm=ctas, card=smi)


def phase_scenario_a_long(tmp, rec, dev, result):
    """5e: scenario A end to end on SCEN_A_LONG (~1,670-residue sequences)
    with WITCH_TPU_DEVICE_EMBED=1: phase 5's checks, its rows against
    ref_scenA_long, the pair-HMM kernel launched on the wide layout at
    every call; then the path's own embedding calls replayed: the wide
    layout's ms beside the first version's on the same calls, plain's
    (its one call) within 2e-4 nats a residue, and the bound."""
    import witch_tpu_torch.ops.pairhmm as ph
    tool = _pairhmm_tool()
    orig_lay, orig_fn, seen, calls = ph.pairhmm_layout, \
        ph.pairhmm_forward_logodds, {}, []

    def layout(C, LB):
        seen[LB] = orig_lay(C, LB)
        return seen[LB]

    def fn(*args, **kw):
        calls.append(args)
        return orig_fn(*args, **kw)

    n_full, n_frag, cols, seed, backbone = SCEN_A_LONG
    os.environ["WITCH_TPU_DEVICE_EMBED"] = "1"
    ph.pairhmm_layout, ph.pairhmm_forward_logodds = layout, fn
    try:
        launches = phase_scenario_a(
            tmp, rec, "5e: scenario A on %d-column sequences with "
            "WITCH_TPU_DEVICE_EMBED=1" % cols, "scenA_long_out",
            (n_full, n_frag, cols, seed), backbone, SCEN_A_LONG_JAX)
    finally:
        del os.environ["WITCH_TPU_DEVICE_EMBED"]
        ph.pairhmm_layout, ph.pairhmm_forward_logodds = orig_lay, orig_fn
    pairs = sum(len(c[1]) for c in calls)
    check(launches["pairhmm"] > 0 and seen
          and all(v[0] == 2 for v in seen.values()),
          "5e: the pair-HMM kernel launched %d times on %d pairs, the wide "
          "layout at every call (LB: layout, CH, G %s; CTAs a SM %s)"
          % (launches["pairhmm"], pairs, seen, _wide_ctas(seen)))
    r = tool.time_calls(calls, 3, first=True, plain_warm=False)
    b_ms, b_by = bound_ms("pairhmm", r["cells"], r["bytes"])
    smi = smi_line()
    say("  5e's %d embedding pairs replayed: wide layout %.3f ms, the first "
        "version %.3f ms on the same calls (max |d log-odds| %.3g), plain "
        "%.1f ms; %.4g cells, bound %.4f ms (%s); %s"
        % (pairs, r["ms"], r["ms_first_version"],
           r["max_abs_diff_first_version"], r["plain_ms"], r["cells"], b_ms,
           b_by, smi))
    check(r["max_abs_err_per_residue"] <= 2e-4,
          "5e: the path's embedding, kernel vs plain max |d log-odds| %.3g "
          "nats, %.3g a residue <= 2e-4"
          % (r["max_abs_err_logodds"], r["max_abs_err_per_residue"]))
    result["pairhmm_scenario_a_long"] = dict(
        max_abs_err=r["max_abs_err_per_residue"], ms=r["ms"],
        plain_ms=r["plain_ms"], cells=r["cells"], bound_ms=b_ms,
        bound_by=b_by, launches=launches["pairhmm"], pairs=pairs,
        ms_first_version=r["ms_first_version"],
        max_abs_diff_first_version=r["max_abs_diff_first_version"],
        layouts=r["layouts"], card=smi)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        say("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "False); nothing run")
        return 2
    t_start = time.time()
    smi = smi_line()
    say("card:", smi)
    say("card host: os.cpu_count() %d" % os.cpu_count())
    dev = torch.device("cuda")
    # every phase but 4m scores on one card, whatever the host holds
    os.environ["WITCH_TPU_NO_MESH"] = "1"
    from witch_tpu_torch import _build
    t0 = time.time()
    _build.lib()
    say("nvcc build of csrc/*.cu: %.2f s" % (time.time() - t0))
    t0 = time.time()
    from witch_tpu_torch.native import _domaindef  # noqa: F401 - builds it
    say("native engine build (witch_tpu_torch/native): %.2f s"
        % (time.time() - t0))

    import witch_tpu_torch.aligner as al
    orig_init = al.DeviceAligner.__init__

    def init(self, *a, **kw):
        orig_init(self, *a, **kw)
        REC_ALIGNER[:] = [self]
    al.DeviceAligner.__init__ = init

    result = {}
    paths = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        ROOT, "build"))
    try:
        banks, codes, lens = timed(phase_forward, dev, result)
        timed(phase_bench, result)
        timed(phase_flank, banks, codes, lens, dev, result)
        rec = Recorder()
        paths["amino500"] = timed(phase_amino, tmp, rec)
        paths["serve"] = timed(phase_serve, tmp)
        timed(phase_forward_path, list(rec.fwd), dev, result, "2f_amino500")
        timed(phase_null2, rec, dev, result)
        timed(phase_oa, rec, banks, codes, lens, dev, result)
        timed(phase_cluster, result)
        timed(phase_wide, rec, dev, result)
        paths["full_search"] = timed(phase_full_search, tmp, rec, dev,
                                     result)
        paths["old_witch"] = timed(phase_old_witch, tmp, rec)
        paths["dna1k"] = timed(phase_dna, tmp, rec)
        timed(phase_overlay, rec, dev, result)
        timed(phase_effn, rec, dev, result)
        timed(phase_forward_path, list(rec.fwd), dev, result, "4d_dna1k",
              100)
        timed(phase_oa_path, rec, dev, result, "4e: oa kernel on dna1k's "
              "alignment pairs", "4e_dna1k")
        paths["mesh"] = timed(phase_mesh, tmp, list(rec.fwd),
                              list(rec.fwd_bits), result)
        paths["full_search_dna"] = timed(phase_full_search_dna, tmp, rec,
                                         dev, result)
        paths["dnawide"] = timed(phase_dnawide, tmp, rec, dev, result)
        timed(phase_forward_path, list(rec.fwd), dev, result, "4wd_dnawide",
              2)
        timed(phase_null2, rec, dev, result, "4wn: null2 kernel vs plain, "
              "dnawide gate envelopes", "null2_dnawide", 16, False)
        timed(phase_oa_path, rec, dev, result, "4wo: oa kernel on dnawide's "
              "alignment pairs, and its first version", "4w_dnawide", 16,
              True, 1)
        paths["dnawide_full"] = timed(phase_full_search_dnawide, tmp, rec,
                                      dev, result)
        paths["scenario_c"] = timed(phase_scenario_c, tmp, rec)
        paths["sharded"] = timed(phase_sharded, tmp)
        golden = timed(phase_dna_golden, tmp)
        if golden:
            paths["dna_golden"] = golden
        paths["scenario_a"] = timed(phase_scenario_a, tmp, rec)
        timed(phase_null2, rec, dev, result, "5b: null2 kernel vs plain, "
              "scenario A gate envelopes", "null2_scenario_a", 1024, False)
        timed(phase_embed, tmp, dev, result)
        timed(phase_embed_wide, tmp, dev, result)
        paths["scenario_a_device_embed"] = timed(phase_scenario_a_embed,
                                                 tmp, rec)
        paths["scenario_a_long"] = timed(phase_scenario_a_long, tmp, rec,
                                         dev, result)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for name, src, rep, main_path in (
            ("forward", "witch_tpu_torch/csrc/forward.cu",
             "witch_tpu/ops/pallas_forward.py:30", "amino500"),
            ("null2", "witch_tpu_torch/csrc/null2.cu",
             "witch_tpu/ops/pallas_null2.py:54", "amino500"),
            ("oa", "witch_tpu_torch/csrc/oa.cu",
             "witch_tpu/ops/pallas_oa.py:55", "amino500"),
            ("flank", "witch_tpu_torch/csrc/flank.cu",
             "witch_tpu/hmm/flank_device.py:52", "full_search"),
            ("pairhmm", "witch_tpu_torch/csrc/pairhmm.cu",
             "witch_tpu/ops/pairhmm_forward.py:27",
             "scenario_a_device_embed")):
        r = result[name]
        b_ms, b_by = bound_ms(name, r["cells"], r["bytes"])
        k = dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=paths[main_path][name],
                 launches_by_path={p: paths[p][name] for p in paths},
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, cells=r["cells"])
        # OA's entry also carries its stored rows' bound and, per tag,
        # the pairs and which bound binds
        extras = ("bound_ms", "envelopes", "launches", "rows_bytes_ms")
        if name in ("oa", "flank"):
            # the cluster meeting's ns and the co-resident clusters
            # (phase 2h), and per tag the first version on the same calls
            k["cluster"] = result["cluster"]
            extras += ("ms_first_version", "launches_first_version")
        if name == "oa":
            k["rows_bytes_ms"] = r["rows_bytes_ms"]
            extras += ("bound_by", "pairs")
        if name == "flank":
            # the stored specials' and outputs' bound, and the layout
            # (layout, G, npl, Mpad) of each width it ran at
            k["rows_bytes_ms"] = r["rows_bytes_ms"]
            k["layouts"] = {str(mp): list(v) for t in (
                "", "_full_search", "_full_search_dna", "_full_search_dnawide")
                            for mp, v in result.get(name + t, {}).get(
                                "layouts", {}).items()}
            extras += ("bound_by", "pairs")
        if name == "forward":
            # the data mesh (4m): its cards, each card's kernel ms on
            # dna1k's banks, the mesh's and one card's wall a call
            k["mesh"] = result["mesh"]
        if name == "pairhmm":
            # the first version's ms on the same calls, the layout (layout,
            # CH, G) at each width, and each instance's registers, spills
            # and warps a SM
            k.update({x: r[x] for x in (
                "pairs", "max_abs_err_logodds", "ms_first_version",
                "max_abs_diff_first_version", "layouts")})
            # every width's layout, the register kernel's (5c) and the
            # wide layout's (5w, 5e)
            for t in ("dnawide_embed", "scenario_a_long"):
                k["layouts"].update(result.get("pairhmm_" + t, {}).get(
                    "layouts", {}))
            k["ptxas"] = {p["kernel"]: [p["registers"], p["spill_stores"],
                                        p["spill_loads"], p["warps_per_sm"]]
                          for p in r["ptxas"]}
            extras += ("bound_by", "pairs", "cells", "ms_first_version",
                       "max_abs_diff_first_version", "layouts",
                       "ctas_per_sm", "plain_pairs", "ms_plain_pairs")
        for tag in ("wide", "full_search", "full_search_dna", "2f_amino500",
                    "4d_dna1k", "4e_dna1k", "bench", "scenario_a",
                    "dna1k_backbone", "4wd_dnawide", "dnawide", "4w_dnawide",
                    "full_search_dnawide", "dnawide_embed",
                    "scenario_a_long"):
            r2 = result.get("%s_%s" % (name, tag))
            if r2:
                k.update({"ms_" + tag: r2["ms"],
                          "plain_ms_" + tag: r2["plain_ms"],
                          "max_abs_err_" + tag: r2["max_abs_err"]})
                for extra in extras:
                    if extra in r2:
                        k["%s_%s" % (extra, tag)] = r2[extra]
                k["max_abs_err"] = max(k["max_abs_err"], r2["max_abs_err"])
        kernels.append(k)
    # the print overlay (4o): bound by its serial chains, not operations or
    # bytes; its plain time is the native engine's on the same pairs, its
    # error the pairs that differ from it
    r = result["overlay"]
    kernels.append(dict(
        name="overlay", route="cuda", source="witch_tpu_torch/csrc/overlay.cu",
        replaces="none (witch_tpu/pipeline.py:420 host engine)",
        launches=paths["dna1k"]["overlay"],
        launches_by_path={p: paths[p]["overlay"] for p in paths},
        differ=r["differ"], ms=r["ms"], plain_ms=r["native_s"] * 1e3,
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
        launch=r["launch"], pairs=r["pairs"]))
    # the entropy weighting (4h): bound by its f64 operations; its plain
    # time is the plain version's on the same card tensors, its error the
    # models whose effn differs from the plain version's or the host's
    r = result["effn"]
    kernels.append(dict(
        name="effn", route="cuda", source="witch_tpu_torch/csrc/effn.cu",
        replaces="none (witch_tpu/hmm/build.py:entropy_weight host NumPy)",
        launches=paths["dna1k"]["effn"],
        launches_by_path={p: paths[p].get("effn", 0) for p in paths},
        library_ms=None, **r))
    say("chip_smoke: all phases passed in %.1f s" % (time.time() - t_start))
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "witch_tpu") and sys.modules[m] is not None)
    if foreign:
        raise AssertionError("modules of JAX or witch_tpu were loaded: %s"
                             % foreign[:10])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
