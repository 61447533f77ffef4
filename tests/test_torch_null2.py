"""The port's null2 wrapper (witch_tpu_torch/ops/null2.py): the launch
planner on made-up lengths and models, the wrapper's results in input
order under a plan of many launches (plain version on the CPU, against
itself unplanned and the JAX package in interpret mode), and on the card
the CUDA kernel against the plain version at the bank widths the port
meets."""

import numpy as np
import pytest
import torch

from witch_tpu.core.alphabet import DNA
from witch_tpu.hmm.bank import build_banks
from witch_tpu.hmm.build import build_hmm, quantize_like_text
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.ops.null2 import (_pack, n2_layout, null2_nats,
                                       null2_nats_ref, plan_launches,
                                       scratch_row_bytes)

LETTERS = np.array(list("ACGT"))


def synth_core(M, n, seed):
    """A DNA model of M states from n mutated copies of a random base."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, M)
    rows = []
    for _ in range(n):
        s = base.copy()
        mut = r.random(M) < 0.15
        s[mut] = r.integers(0, 4, mut.sum())
        rows.append(DNA.encode("".join(LETTERS[s])))
    return quantize_like_text(build_hmm(np.array(rows), DNA, "dna"))


def _made_up(seed, n, n_models, lmax):
    rng = np.random.default_rng(seed)
    lds = rng.integers(1, lmax + 1, n)
    lds[rng.random(n) < 0.2] = lmax             # ties at the longest
    return lds, rng.integers(0, n_models, n)


@pytest.mark.parametrize("seed,n,n_models,wp,budget_rows", [
    (1, 1, 1, 8, 1), (2, 40, 3, 8, 60), (3, 257, 7, 4, 500),
    (4, 1000, 1, 1, 100000), (5, 123, 5, 2, 1)])
def test_plan_launches_places_every_envelope_once(seed, n, n_models, wp,
                                                  budget_rows):
    lds, models = _made_up(seed, n, n_models, 90)
    row_bytes = scratch_row_bytes(512)
    budget = budget_rows * row_bytes
    plan = plan_launches(lds, models, wp, row_bytes, budget)
    slots = plan.cta_env.reshape(-1, wp)
    placed = plan.cta_env[plan.cta_env >= 0]
    assert sorted(placed.tolist()) == list(range(n))      # each once
    assert plan.cta0[0] == 0 and plan.cta0[-1] == len(slots)
    assert np.all(np.diff(plan.cta0) >= 1)                 # none empty
    firsts = []
    for c in slots:
        env = c[c >= 0]
        assert len(env) >= 1 and c[0] >= 0                 # first slot filled
        assert np.all(c[len(env):] < 0)                    # empties at the end
        assert len(set(models[env].tolist())) == 1         # one model
        assert np.all(np.diff(lds[env]) <= 0)              # longest first
        firsts.append(lds[env[0]])
    assert np.all(np.diff(firsts) <= 0)                    # CTAs longest first
    for t, (a, b) in enumerate(zip(plan.cta0[:-1], plan.cta0[1:])):
        env = plan.cta_env[a * wp:b * wp]
        env = env[env >= 0]
        assert plan.n_rows[t] == int(lds[env].sum())
        if b - a > 1:                                      # fits the budget
            assert plan.n_rows[t] * row_bytes <= budget
        spans = sorted((int(plan.roff[e]), int(plan.roff[e] + lds[e]))
                       for e in env)
        assert spans[0][0] == 0 and spans[-1][1] == plan.n_rows[t]
        for (_, end), (start, _) in zip(spans[:-1], spans[1:]):
            assert end == start                            # no overlap, no gap
    if budget_rows == 1:
        assert plan.launches == len(slots)                 # one CTA each


def test_plan_launches_one_launch_when_the_budget_holds_all():
    lds, models = _made_up(6, 300, 4, 200)
    plan = plan_launches(lds, models, 8, 4, int(lds.sum()) * 4)
    assert plan.launches == 1 and plan.n_rows == [int(lds.sum())]


def _entries(seed, n_models, lens, M):
    rng = np.random.default_rng(seed)
    out = []
    for h in range(n_models):
        base = np.random.default_rng(seed + h).integers(0, 4, M[h])
        for L in lens:
            if rng.random() < 0.5 and L <= M[h]:
                a = int(rng.integers(0, M[h] - L + 1))
                q = base[a:a + L].copy()
                mut = rng.random(L) < 0.1
                q[mut] = rng.integers(0, 4, int(mut.sum()))
            else:
                q = rng.integers(0, 4, L)
            extra = int(rng.integers(0, 40))
            out.append((h, q.astype(np.int32), L + extra))
    return out


@pytest.mark.parametrize("budget_rows", [None, 1, 50])
def test_null2_nats_cpu_plan_keeps_input_order(budget_rows):
    cores = [synth_core(30, 6, 3), synth_core(44, 6, 4), synth_core(37, 6, 5)]
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    bt = bank_to_torch(bank, "cpu")
    entries = _entries(21, 3, [1, 2, 5, 13, 40, 60], [30, 44, 37])
    order = np.random.default_rng(2).permutation(len(entries))
    entries = [entries[t] for t in order]
    pk = _pack(entries, "cpu")
    _, _, _, Mpad = n2_layout(bt.Mp)
    budget = None if budget_rows is None \
        else budget_rows * scratch_row_bytes(Mpad)
    s, d = null2_nats(bt, *pk, budget=budget)
    sr, dr = null2_nats_ref(bt, *pk)
    torch.testing.assert_close(s, sr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d, dr, rtol=1e-5, atol=1e-6)


def test_null2_nats_cpu_many_launches_match_jax_interpret():
    from witch_tpu.ops.pallas_null2 import null2_envelopes_device
    from witch_tpu_torch.ops.null2 import null2_envelopes
    cores = [synth_core(26, 6, 7), synth_core(33, 6, 8)]
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    entries = _entries(5, 2, [1, 3, 9, 24, 31], [26, 33])
    import witch_tpu_torch.ops.null2 as n2
    orig = n2.null2_nats
    n2.null2_nats = lambda bt, *a: orig(bt, *a, budget=scratch_row_bytes(64))
    try:
        got = null2_envelopes(bank_to_torch(bank, "cpu"), entries)
    finally:
        n2.null2_nats = orig
    ref = null2_envelopes_device(bank, entries, QT=4, B=8, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---- on the card -------------------------------------------------------
# model sizes whose bank widths are Mp 416, 1,440, 2,720, 8,224, 16,416
WIDTHS = {416: (384, 350, 300), 1440: (1408, 1350, 1200),
          2720: (2688, 2500), 8224: (8191,), 16416: (16384,)}
LENS = (1, 2, 7, 33, 150, 600, 1400)


@pytest.mark.cuda
@pytest.mark.parametrize("Mp", sorted(WIDTHS))
def test_null2_kernel_matches_plain_across_widths(Mp):
    """Lengths 1 to 1,400 over several models of one bank; the same
    envelopes again under a budget that splits them into many launches
    give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch import _build
    Ms = WIDTHS[Mp]
    cores = [synth_core(M, 4, 30 + i) for i, M in enumerate(Ms)]
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    bt = bank_to_torch(bank, "cuda")
    assert bt.Mp == Mp
    entries = _entries(Mp, len(Ms), LENS, list(Ms))
    pk = _pack(entries, "cuda")
    _build.reset_launches()
    sk, dk = null2_nats(bt, *pk)
    assert _build.LAUNCHES["null2"] == 1
    sp, dp = null2_nats_ref(bt, *pk, chunk=8)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dk, dp, rtol=1e-4, atol=1e-5)
    _, _, _, Mpad = n2_layout(Mp)
    small = 1500 * scratch_row_bytes(Mpad)
    _build.reset_launches()
    s2, d2 = null2_nats(bt, *pk, budget=small)
    assert _build.LAUNCHES["null2"] > 1
    assert torch.equal(s2, sk) and torch.equal(d2, dk)
