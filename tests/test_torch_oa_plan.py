"""The port's OA wrapper around its warp-per-pair kernel
(witch_tpu_torch/ops/oa.py): the width dispatch (oa_layout), the launch
plan with OA's scratch rows, and the plain traceback on the kernel's
pointer plane (rows of Mpad states) against the plain Mp-wide one, with
the plain version against the JAX package in interpret mode."""

import numpy as np
import pytest

from witch_tpu.hmm.bank import build_banks
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.ops.oa import (oa_layout, oa_ref, oa_row_bytes,
                                    pack_pairs)
from witch_tpu_torch.ops.plan import plan_launches

from test_torch_oa import _cores


@pytest.mark.parametrize("Mp,want", [
    (416, (0, 2, 8, 512)), (1312, (0, 6, 8, 1536)),
    (1440, (0, 6, 8, 1536)), (1568, (0, 7, 8, 1792)),
    (2048, (0, 8, 8, 2048)), (2049, (0, 5, 16, 2560)),
    (2720, (0, 6, 16, 3072)), (4000, (0, 8, 16, 4096)),
    (4096, (0, 8, 16, 4096)), (4097, (1, 24, 8, 6144)),
    (4128, (1, 24, 8, 6144)), (16416, (1, 40, 16, 20480))])
def test_oa_layout_by_width(Mp, want):
    """The warp-per-pair kernel up to Mp 4,096; above, the cluster
    instance (G = 8 C warps on C CTAs; tests/test_torch_wide.py holds
    every cluster boundary)."""
    got = oa_layout(Mp)
    assert got == want
    layout, G, npl, Mpad = got
    if layout == 0:
        assert Mpad == 32 * G * npl >= Mp and G <= 8
        assert 32 * (G - 1) * npl < Mp          # no warp idle
    else:
        assert Mpad == 32 * G * npl >= Mp and G % 8 == 0 and 16 <= G <= 64
        assert 32 * (G - 8) * npl < Mp          # no CTA idle


@pytest.mark.parametrize("seed,n,n_models,Mp,budget_rows", [
    (1, 1, 1, 416, 1), (2, 60, 4, 416, 300), (3, 300, 9, 1440, 2000),
    (4, 800, 2, 1568, 10 ** 6), (5, 97, 5, 2720, 1)])
def test_oa_plan_places_every_pair_once(seed, n, n_models, Mp, budget_rows):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 900, n)
    lens[rng.random(n) < 0.2] = 899
    models = rng.integers(0, n_models, n)
    _, G, _, Mpad = oa_layout(Mp)
    wp = max(1, 8 // G)
    row_bytes = oa_row_bytes(Mpad)
    assert row_bytes == 9 * Mpad + 17
    budget = budget_rows * row_bytes
    plan = plan_launches(lens, models, wp, row_bytes, budget)
    slots = plan.cta_env.reshape(-1, wp)
    placed = plan.cta_env[plan.cta_env >= 0]
    assert sorted(placed.tolist()) == list(range(n))      # each pair once
    firsts = []
    for c in slots:
        pairs = c[c >= 0]
        assert c[0] >= 0 and np.all(c[len(pairs):] < 0)
        assert len(set(models[pairs].tolist())) == 1      # one model a CTA
        assert np.all(np.diff(lens[pairs]) <= 0)          # longest first
        firsts.append(lens[pairs[0]])
    assert np.all(np.diff(firsts) <= 0)
    for t, (a, b) in enumerate(zip(plan.cta0[:-1], plan.cta0[1:])):
        pairs = plan.cta_env[a * wp:b * wp]
        pairs = pairs[pairs >= 0]
        assert plan.n_rows[t] == int(lens[pairs].sum())
        if b - a > 1:
            assert plan.n_rows[t] * row_bytes <= budget    # within budget
        spans = sorted((int(plan.roff[e]), int(plan.roff[e] + lens[e]))
                       for e in pairs)
        assert spans[0][0] == 0 and spans[-1][1] == plan.n_rows[t]
        for (_, end), (start, _) in zip(spans[:-1], spans[1:]):
            assert end == start                            # no overlap
    if budget_rows == 1:
        assert plan.launches == len(slots)


@pytest.mark.parametrize("seed", [7, 23])
def test_trace_on_kernel_pointer_plane(seed):
    """The plain version traced from Mpad-wide pointer rows (the
    kernel's plane, ops/oa.py:ptr_at) gives the columns and stats of the
    Mp-wide plane, and both hold against the JAX kernel in interpret
    mode above the guard."""
    from witch_tpu.ops.pallas_oa import oa_columns_device
    rng = np.random.default_rng(seed)
    cores = _cores(rng)
    banks = build_banks(cores, indices=[0, 1, 2], multihit=True,
                        uniform=True, n_buckets=2)
    bank_row = {int(idx): (bi, r) for bi, b in enumerate(banks)
                for r, idx in enumerate(b.hmm_indices)}
    pairs = [(int(rng.integers(0, 3)),
              rng.integers(0, 4, int(rng.integers(20, 90))).astype(np.int32))
             for _ in range(8)]
    jcols, jmargins, _ = oa_columns_device(banks, bank_row, pairs, QT=4,
                                           B=8, interpret=True)
    for bi, b in enumerate(banks):
        mine = [p for p, (idx, _) in enumerate(pairs)
                if bank_row[idx][0] == bi]
        if not mine:
            continue
        bt = bank_to_torch(b, "cpu")
        pk = pack_pairs(bt, [(bank_row[pairs[p][0]][1], pairs[p][1])
                             for p in mine])
        Mpad = oa_layout(bt.Mp)[3]
        assert Mpad > bt.Mp
        c0, s0 = oa_ref(bt, *pk)
        c1, s1 = oa_ref(bt, *pk, Mpad=Mpad)
        np.testing.assert_array_equal(c0.numpy(), c1.numpy())
        np.testing.assert_array_equal(s0.numpy(), s1.numpy())
        off = pk[3].numpy()
        for t, p in enumerate(mine):
            if s1[t, 0] >= 2e-3:
                np.testing.assert_array_equal(
                    c1.numpy()[off[t]:off[t] + len(pairs[p][1])], jcols[p])


@pytest.mark.parametrize("Mp,G,npl", [(416, 2, 8), (1440, 6, 8),
                                      (2720, 6, 16)])
def test_oa_tables_layout(Mp, G, npl):
    """The warp-per-pair kernel's tables: emissions in k order padded to
    Mpad, transitions as float4s of a lane's states in lane order."""
    import torch
    from witch_tpu_torch.device import BankTensors
    from witch_tpu_torch.ops.oa import oa_tables
    H, K = 2, 4
    em = torch.arange(H * K * Mp, dtype=torch.float32).reshape(H, K, Mp) + 1
    trans = torch.arange(H * 8 * Mp, dtype=torch.float32).reshape(H, 8, Mp)
    bt = BankTensors(em=em, trans=trans + 1, M=np.full(H, Mp - 32),
                     pad_code=K - 1)
    em_k, tr_q = oa_tables(bt, G, npl)
    Mpad = 32 * G * npl
    assert em_k.shape == (H, K, Mpad) and tr_q.shape == (H, 8, Mpad)
    assert torch.equal(em_k[:, :, :Mp], bt.em)
    assert not em_k[:, :, Mp:].any()
    S, hq = 32 * G, npl // 4
    for r in (0, 6, 7):
        for k in (0, 1, 5, npl - 1, npl, Mp - 1, Mp, Mpad - 1):
            s, j = divmod(k, npl)
            at = ((0 * hq + j // 4) * S + s) * 4 + j % 4
            want = float(bt.trans[1, r, k]) if k < Mp else 0.0
            assert float(tr_q[1, r, at]) == want
    assert oa_tables(bt, G, npl)[1] is tr_q          # cached on the bank
