"""The exact-f32 print overlay's split chain (witch_tpu_torch/ops/overlay.py):
exact_scores32 split at its transcendental functions, with its launches
on the host engine (HostLauncher: exact32_intermediates), held bit for bit
against the JAX package's native exact_scores32 (its models built by the
JAX package from the same rows) on DNA models made here and amino models
built from the amino golden's backbone; the routing (wide models and
multidomain pairs to exact_scores32, the CPU device to the host engine's
launches) and the span counters; and on the card the kernel
(csrc/overlay.cu) against the host engine's launch outputs and the
scores through it against the JAX package's."""

import numpy as np
import pytest
import torch

from witch_tpu_torch import spans
from witch_tpu_torch.core.alignment import PackedAlignment
from witch_tpu_torch.core.alphabet import ALPHABETS, DNA
from witch_tpu_torch.hmm.build import build_hmm, quantize_like_text
from witch_tpu_torch.hmm.profile import configure
from witch_tpu_torch.io.fasta import read_fasta
from witch_tpu_torch.native import _domaindef, set_trace_alphabet
from witch_tpu_torch.ops import overlay as ov
from witch_tpu_torch.pipeline import _native_args

GOLDEN = "tests/golden/ref_amino"
LETTERS = np.array(list("ACGT"))


def _dna_rows(M, n, seed):
    """n mutated copies of a random base of M residues, and the base."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, M)
    rows = []
    for _ in range(n):
        s = base.copy()
        mut = r.random(M) < 0.15
        s[mut] = r.integers(0, 4, mut.sum())
        rows.append(DNA.encode("".join(LETTERS[s])))
    return np.array(rows), base


def _xargs(rows, molecule, side):
    """The native engine's model arguments of the model built from rows,
    by the port (side "port") or by the JAX package (side "jax")."""
    import witch_tpu.core.alphabet as jax_alphabet
    import witch_tpu.hmm.build as jax_build
    import witch_tpu.hmm.profile as jax_profile
    if side == "port":
        core = quantize_like_text(build_hmm(rows, ALPHABETS[molecule],
                                            molecule))
        return _native_args(configure(core, multihit=True))
    core = jax_build.quantize_like_text(jax_build.build_hmm(
        rows, jax_alphabet.ALPHABETS[molecule], molecule))
    p = jax_profile.configure(core, multihit=True)
    return [np.ascontiguousarray(p.msc, np.float64)] + [
        np.ascontiguousarray(getattr(p, a), np.float64)
        for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm", "t_dd",
                  "bm")]


def _enc(s):
    return np.ascontiguousarray(DNA.encode("".join(LETTERS[s])), np.int32)


def dna_jobs(side="port"):
    """Three DNA models, each against fragments of every shape the
    overlay meets: whole and partial copies, two copies apart (two
    regions), two copies joined (a multidomain region), random residues,
    a run of one base (no region), and one residue."""
    set_trace_alphabet("dna")
    rng = np.random.default_rng(5)

    def mut(s, p=0.1):
        s = s.copy()
        m = rng.random(len(s)) < p
        s[m] = rng.integers(0, 4, m.sum())
        return s

    jobs = []
    for M, seed in ((60, 1), (150, 2), (33, 3)):
        rows, base = _dna_rows(M, 12, seed)
        qs = []
        for t in range(24):
            kind = t % 6
            if kind == 0:
                s = mut(base)
            elif kind == 1:
                a = int(rng.integers(0, M // 2))
                s = mut(base[a:a + int(rng.integers(5, M // 2 + 5))])
            elif kind == 2:
                s = np.r_[mut(base[:M // 2]), rng.integers(0, 4, 40),
                          mut(base[M // 2:])]
            elif kind == 3:
                s = np.r_[mut(base), rng.integers(0, 4, 60), mut(base)]
            elif kind == 4:
                s = np.r_[mut(base), mut(base)]
            else:
                s = rng.integers(0, 4, int(rng.integers(1, 80)))
            qs.append(_enc(s))
        qs.append(_enc(np.zeros(80, np.int64)))
        qs.append(_enc(np.array([0])))
        jobs.append((_xargs(rows, "dna", side), qs))
    return jobs


def amino_jobs(side="port"):
    """Three amino models built from slices of the amino golden's
    backbone, each against every golden query and a one-residue one."""
    set_trace_alphabet("amino")
    bb = PackedAlignment.from_fasta(GOLDEN + ".backbone.fasta",
                                    molecule="amino")
    amino = ALPHABETS["amino"]
    qs = [np.ascontiguousarray(amino.encode(s.upper()), np.int32)
          for _, s in read_fasta(GOLDEN + ".queries.fasta")]
    qs.append(qs[0][:1].copy())
    jobs = []
    for rows in (slice(0, 12), slice(12, 30), slice(30, 60)):
        jobs.append((_xargs(bb.codes[rows], "amino", side), qs))
    return jobs


JOBS = {"dna": dna_jobs, "amino": amino_jobs}


def reference(data):
    """The JAX package's native exact_scores32 on data's pairs, its
    models built by the JAX package (CPU only: the card's host runs
    nothing of the JAX package)."""
    from witch_tpu.native import _domaindef as ref
    from witch_tpu.native import set_trace_alphabet as ref_alphabet
    jobs = JOBS[data]("jax")
    assert ref_alphabet(data)
    return [ref.exact_scores32(*xargs, cl, 1) for xargs, cl in jobs]


def routes(jobs):
    """exact32_regions' status of every pair, and its regions a pair."""
    out = []
    for xargs, cl in jobs:
        n = len(cl)
        L = np.array([len(c) for c in cl], np.int32)
        f, b, fl, _ = _domaindef.exact32_intermediates(
            *xargs, cl, np.zeros(n, np.int32), L, L, 0, 1)
        nj = np.full(n, ov.table(xargs).nj, np.float32)
        st, _, rp, _, _ = _domaindef.exact32_regions(f, b, fl, L, nj)
        out.append((st, np.bincount(rp, minlength=n)))
    return out


def assert_same(jobs, got, ref):
    ok, seq, pre = got
    for k, (o, s, p) in enumerate(ref):
        np.testing.assert_array_equal(ok[k], o)
        # bit for bit where exact_scores32 decides; 0 where it refuses
        np.testing.assert_array_equal(seq[k], np.where(o == 1, s, 0.0))
        np.testing.assert_array_equal(pre[k], np.where(o == 1, p, 0.0))


@pytest.mark.parametrize("data", ["dna", "amino"])
def test_split_matches_exact_scores32(data):
    jobs = JOBS[data]()
    ok, seq, pre, cnt = ov.exact_scores(jobs, ov.HostLauncher(2), 4)
    assert_same(jobs, (ok, seq, pre), reference(data))
    lens = [len(c) for _, cl in jobs for c in cl]
    assert min(lens) == 1
    if data == "amino":
        longest = max(len(s) for _, s in read_fasta(GOLDEN + ".queries.fasta"))
        assert max(lens) == longest
        assert sum(o.sum() for o in ok) > 0


def test_dna_pairs_take_every_route():
    """The DNA set holds a single-envelope pair, a pair of two
    single-envelope regions, a multidomain pair and a pair with no
    region, and the split routes each as exact32_target would."""
    jobs = dna_jobs()
    st = np.concatenate([s for s, _ in routes(jobs)])
    nreg = np.concatenate([r for _, r in routes(jobs)])
    assert np.any((st == 0) & (nreg == 1))
    assert np.any((st == 0) & (nreg == 2))
    assert np.any(st == 2)
    assert np.any(st == 1)
    _, _, _, cnt = ov.exact_scores(jobs, ov.HostLauncher(), 2)
    assert cnt["multidomain"] == int(np.sum(st == 2))
    assert cnt["device_pairs"] + cnt["refused"] == int(np.sum(st != 2))


def test_wide_models_stay_native(monkeypatch):
    jobs = dna_jobs()
    # at 16 stripes the 150-state model (38 stripes) is the wide one
    monkeypatch.setattr(ov, "Q_MAX", 16)
    ok, seq, pre, cnt = ov.exact_scores(jobs, ov.HostLauncher(), 3)
    assert_same(jobs, (ok, seq, pre), reference("dna"))
    assert cnt["wide"] == len(jobs[1][1])


def test_counters_add_up_to_pairs_and_workers_sit_under_the_overlay():
    jobs = dna_jobs()
    with spans.span("scoring.overlay") as sp:
        ok, seq, pre, cnt = ov.exact_scores(jobs, ov.HostLauncher(), 2, sp)
        sp.counters.update(cnt)
    pairs = sum(len(cl) for _, cl in jobs)
    c = sp.counters
    assert set(c) == {"device_pairs", "native_pairs", "multidomain", "wide",
                      "refused"}
    assert c["device_pairs"] + c["native_pairs"] + c["refused"] == pairs
    assert c["native_pairs"] == c["multidomain"] + c["wide"]
    assert c["device_pairs"] >= 0.5 * pairs
    workers = [s for s in sp.children if s.name == "overlay.model"]
    assert sum(s.counters.get("pairs", 0) for s in workers) == \
        c["native_pairs"]


def test_cpu_device_runs_the_native_engine_alone():
    """On the CPU the overlay is the split chain with its launches on the
    native engine (HostLauncher): the JAX package's scores, no launch,
    the split's counters on the overlay's span, and one overlay.model
    worker a model a launch beside those of the multidomain pairs."""
    jobs = dna_jobs()
    with spans.span("scoring.overlay", kernels="overlay") as sp:
        got = ov.overlay_scores(jobs, torch.device("cpu"), DNA.K, 3, sp)
    assert_same(jobs, got, reference("dna"))
    c = sp.counters
    assert c["launches"] == 0
    assert c["device_pairs"] + c["native_pairs"] + c["refused"] == \
        sum(len(cl) for _, cl in jobs)
    assert c["multidomain"] > 0 and c["wide"] == 0
    workers = [s for s in sp.children if s.name == "overlay.model"]
    assert len(workers) == len(sp.children)
    assert sum(s.counters.get("pairs", 0) for s in workers) == \
        c["multidomain"]
    # launch A: every pair; launch B: the envelopes of the pairs it kept
    items = [s.counters["items"] for s in workers if "items" in s.counters]
    assert len(items) == 2 * len(jobs)
    assert sum(items) > sum(len(cl) for _, cl in jobs)


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["dna", "amino"])
def test_card_launches_match_the_host_engine(data):
    """Both launches on the card give the host engine's own outputs bit
    for bit, and the scores through them are the host launcher's (which
    test_split_matches_exact_scores32 holds against the JAX package's)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from witch_tpu_torch import _build
    jobs = JOBS[data]()
    kc = ALPHABETS[data].K
    tables = [ov.table(xargs) for xargs, _ in jobs]
    codes = [c for _, cl in jobs for c in cl]
    model = np.array([m for m, (_, cl) in enumerate(jobs) for _ in cl],
                     np.int32)
    L = np.array([len(c) for c in codes], np.int32)
    n = len(codes)
    host, card = ov.HostLauncher(2), ov.CardLauncher(torch.device("cuda"),
                                                       kc)
    for la in (host, card):
        la.prepare(tables, codes)
    seq_items = ov.Items(model, np.arange(n, dtype=np.int32),
                         np.zeros(n, np.int32), L, L)
    # every envelope of every pair a launch-B item, and the whole
    # sequence too
    rng = np.random.default_rng(3)
    i0 = np.array([int(rng.integers(0, x)) for x in L], np.int32)
    ld = np.array([int(rng.integers(1, x - a + 1)) for a, x in zip(i0, L)],
                  np.int32)
    env_items = ov.Items(np.r_[model, model], np.r_[np.arange(n), np.arange(n)]
                         .astype(np.int32), np.r_[np.zeros(n, np.int32), i0],
                         np.r_[L, ld], np.r_[L, L])
    n0 = _build.LAUNCHES["overlay"]
    for items, mode in ((seq_items, 0), (env_items, 1)):
        h = host(items, mode)
        c = card(items, mode)
        for got, want in zip(c[:3], h[:3]):     # both xmx rows, flags
            np.testing.assert_array_equal(got, want)
        if mode == 1:
            live = (h[2] & 2) == 0
            np.testing.assert_array_equal(c[3][live], h[3][live])
    assert _build.LAUNCHES["overlay"] == n0 + 2
    got = ov.exact_scores(jobs, card, 4)
    want = ov.exact_scores(jobs, host, 4)
    for a, b in zip(got[:3], want[:3]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
