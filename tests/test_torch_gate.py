"""Port's device gate (plain null2 on the CPU) vs the JAX gate in
interpret mode and vs the native host engine, on the same seeded
inputs and flank rows."""

import numpy as np
import pytest
import torch

from witch_tpu.core.alphabet import DNA
from witch_tpu.hmm.bank import build_banks
from witch_tpu.hmm.build import build_hmm, quantize_like_text
from witch_tpu.hmm.profile import configure
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.hmm.gate_device import evaluate_gate_device
from witch_tpu_torch.ops.null2 import null2_envelopes

try:
    from witch_tpu.native import _domaindef
except ImportError:     # pragma: no cover
    _domaindef = None

LETTERS = np.array(list("ACGT"))
needs_simd = pytest.mark.skipif(
    _domaindef is None or not hasattr(_domaindef, "flank_targets_simd"),
    reason="native AVX-512 engine unavailable")


def synth_core(M, n, seed):
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, M)
    rows = []
    for _ in range(n):
        s = base.copy()
        mut = r.random(M) < 0.15
        s[mut] = r.integers(0, 4, mut.sum())
        rows.append(DNA.encode("".join(LETTERS[s])))
    return quantize_like_text(build_hmm(np.array(rows), DNA, "dna"))


def margs(p):
    return [np.ascontiguousarray(p.msc, np.float64)] + [
        np.ascontiguousarray(getattr(p, a), np.float64)
        for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                  "t_dm", "t_dd", "bm")]


def case(seed):
    cores = [synth_core(36, 10, seed), synth_core(48, 10, seed + 1)]
    rng = np.random.default_rng(100 + seed)
    queries = [DNA.encode("".join(LETTERS[rng.integers(
        0, 4, int(rng.integers(24, 56)))])) for _ in range(3)]
    for h, M in enumerate((36, 48)):
        base = np.random.default_rng(seed + h).integers(0, 4, M)
        s = base.copy()
        mut = rng.random(M) < 0.1
        s[mut] = rng.integers(0, 4, mut.sum())
        queries.append(DNA.encode("".join(LETTERS[s])))
    return cores, queries


@needs_simd
@pytest.mark.parametrize("seed", [1, 11])
def test_gate_matches_native_and_jax(seed):
    from witch_tpu.hmm.gate_device import \
        evaluate_gate_device as evaluate_gate_jax
    cores, queries = case(seed)
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    clist = [np.ascontiguousarray(c, np.int32) for c in queries]
    allargs = {j: margs(configure(c, multihit=True))
               for j, c in enumerate(cores)}
    by_j = {j: list(range(len(clist))) for j in range(len(cores))}
    flank_rows, oracle = {}, {}
    for j in by_j:
        _, mo, pb, pe = _domaindef.flank_targets_simd(*allargs[j], clist, 1)
        flank_rows[j] = (mo, pb, pe)
        oracle[j] = _domaindef.evaluate_targets_rows(
            *allargs[j], clist, 42, 200, 1, 0, mo, pb, pe, 1)
    loc = {j: (0, j) for j in by_j}
    got, stats = evaluate_gate_device(
        [bank_to_torch(bank, "cpu")], loc, allargs, queries, by_j,
        flank_rows, nthreads=2)
    ref, _ = evaluate_gate_jax([bank], loc, allargs, queries, by_j,
                               flank_rows, interpret=True, nthreads=2)
    assert stats["entries"] >= 1
    for other in (oracle, ref):
        for j in by_j:
            for t in range(len(clist)):
                for col in (0, 1, 6):        # nreg, nenv, ld: exact
                    assert other[j][col][t] == got[j][col][t], (j, t, col)
                assert abs(other[j][2][t] - got[j][2][t]) < 2e-3
                assert abs(other[j][4][t] - got[j][4][t]) < 2e-3
                assert abs(other[j][5][t] - got[j][5][t]) < 5e-3


@needs_simd
def test_gate_stats_name_each_window():
    """Each window of the gate is a span under the caller's: the device
    thread's (gate.null2, on its own thread, with the null2 kernel's ms
    and launches), apart from the host multidomain pool (gate.multidomain)
    and the join after it (gate.wait); on the CPU no kernel runs, so its
    ms and launches stay 0. The stats carry no timing of their own."""
    from witch_tpu_torch import spans
    cores, queries = case(3)
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    clist = [np.ascontiguousarray(c, np.int32) for c in queries]
    allargs = {j: margs(configure(c, multihit=True))
               for j, c in enumerate(cores)}
    by_j = {j: list(range(len(clist))) for j in range(len(cores))}
    flank_rows = {}
    for j in by_j:
        _, mo, pb, pe = _domaindef.flank_targets_simd(*allargs[j], clist, 1)
        flank_rows[j] = (mo, pb, pe)
    with spans.span("scoring.gate") as gate:
        _, stats = evaluate_gate_device(
            [bank_to_torch(bank, "cpu")], {j: (0, j) for j in by_j},
            allargs, queries, by_j, flank_rows, nthreads=2)
    null2 = gate.child("gate.null2")
    assert stats["entries"] >= 1 and null2.seconds > 0.0
    assert null2.counters == {"envelopes": stats["entries"],
                              "launches": 0, "kernel_ms": 0.0}
    assert null2.tid != gate.tid
    assert [c.name for c in gate.children if c.tid == gate.tid] == [
        "gate.classify", "gate.multidomain", "gate.wait", "gate.assemble"]
    assert gate.child_seconds("gate.multidomain") >= 0.0
    assert not {k for k in stats if k.startswith("t_")}
    assert "null2_kernel_ms" not in stats and "null2_launches" not in stats


def test_null2_envelopes_match_jax_interpret():
    from witch_tpu.ops.pallas_null2 import null2_envelopes_device
    cores = [synth_core(30, 8, 3), synth_core(41, 8, 4)]
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    rng = np.random.default_rng(9)
    entries = []
    for _ in range(5):
        L = int(rng.integers(30, 60))
        q = rng.integers(0, 4, L).astype(np.int32)
        a = int(rng.integers(0, L // 3))
        b = int(rng.integers(a + 8, L))
        entries.append((int(rng.integers(0, 2)), q[a:b], L))
    es, nd, ui, ut = null2_envelopes(bank_to_torch(bank, "cpu"), entries)
    es2, nd2, ui2, ut2 = null2_envelopes_device(bank, entries, QT=4, B=8,
                                                interpret=True)
    np.testing.assert_allclose(es, es2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ui, ui2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ut, ut2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nd, nd2, rtol=1e-4, atol=1e-5)


def test_null2_wrapper_rejects_mixed_devices():
    bank = build_banks([synth_core(20, 6, 5)], uniform=True)[0]
    bt = bank_to_torch(bank, "cpu")
    t = torch.zeros(1, dtype=torch.int32, device="meta")
    from witch_tpu_torch.ops.null2 import null2_nats
    with pytest.raises(ValueError):
        null2_nats(bt, t, t, t, t, t)


@pytest.mark.cuda
def test_null2_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch.ops.null2 import _pack, null2_nats_ref
    from witch_tpu_torch.ops.null2 import null2_nats
    cores = [synth_core(30, 8, 3), synth_core(41, 8, 4)]
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    rng = np.random.default_rng(9)
    entries = []
    for _ in range(9):
        L = int(rng.integers(30, 60))
        q = rng.integers(0, 4, L).astype(np.int32)
        entries.append((int(rng.integers(0, 2)), q[3:L - 2], L))
    bt = bank_to_torch(bank, "cuda")
    pk = _pack(entries, "cuda")
    sk, dk = null2_nats(bt, *pk)
    sp, dp = null2_nats_ref(bt, *pk)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8191, 16384])
def test_null2_kernel_wide_models_match_plain(M):
    """Mp 8,224 and 16,416 (the 16,384-state cap); at 16,416 the four
    working rows exceed shared memory and live in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch.ops.null2 import _pack, null2_nats, null2_nats_ref
    bank = build_banks([synth_core(M, 4, 13)], uniform=True)[0]
    rng = np.random.default_rng(M)
    base = np.random.default_rng(13).integers(0, 4, M)
    entries = []
    for _ in range(4):
        a = int(rng.integers(0, M - 200))
        q = base[a:a + int(rng.integers(80, 200))].astype(np.int32)
        entries.append((0, q[5:len(q) - 5], len(q)))
    bt = bank_to_torch(bank, "cuda")
    pk = _pack(entries, "cuda")
    sk, dk = null2_nats(bt, *pk)
    sp, dp = null2_nats_ref(bt, *pk)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-5)
