"""Port's fused posterior+OA (plain version on the CPU) vs the JAX
kernel in interpret mode and vs the f64 host chain (align_ref)."""

import numpy as np
import pytest
import torch

from witch_tpu.core.alphabet import ALPHABETS
from witch_tpu.hmm.align_ref import aligned_columns
from witch_tpu.hmm.bank import build_banks
from witch_tpu.hmm.build import build_hmm
from witch_tpu.hmm.profile import configure
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.ops.oa import bank_strictly_positive, oa_columns

GUARD = 2e-3


def _cores(rng, n_models=3):
    alpha = ALPHABETS["dna"]
    cores = []
    for h in range(n_models):
        n, L = 8, 40 + h * 17
        codes = rng.integers(0, 4, (n, L))
        codes = np.where(rng.random((n, L)) < 0.15, alpha.gap_code, codes)
        cores.append(build_hmm(codes.astype(np.uint8), alpha, "dna",
                               name="t%d" % h))
    return cores


@pytest.mark.parametrize("seed", [7, 23])
def test_oa_matches_jax_and_host(seed):
    from witch_tpu.ops.pallas_oa import oa_columns_device
    rng = np.random.default_rng(seed)
    cores = _cores(rng)
    banks = build_banks(cores, indices=[0, 1, 2], multihit=True,
                        uniform=True, n_buckets=2)
    assert all(bank_strictly_positive(b) for b in banks)
    bank_row = {int(idx): (bi, r) for bi, b in enumerate(banks)
                for r, idx in enumerate(b.hmm_indices)}
    pairs = []
    for _ in range(8):
        idx = int(rng.integers(0, 3))
        pairs.append((idx, rng.integers(0, 4, int(rng.integers(20, 90)))
                      .astype(np.int32)))
    cols, margins, oks = oa_columns(
        [bank_to_torch(b, "cpu") for b in banks], bank_row, pairs,
        Ldmax=96)
    jcols, jmargins, joks = oa_columns_device(
        banks, bank_row, pairs, QT=4, B=8, interpret=True)
    n_match = 0
    for p, (idx, c) in enumerate(pairs):
        assert oks[p] and joks[p]
        ref = aligned_columns(configure(cores[idx], multihit=False), c)
        if margins[p] >= GUARD:
            assert np.array_equal(cols[p], ref), p
            assert np.array_equal(cols[p], jcols[p]), p
        n_match += np.array_equal(cols[p], ref)
        if np.isfinite(margins[p]) and np.isfinite(jmargins[p]):
            assert abs(margins[p] - jmargins[p]) < 1e-4, (
                p, margins[p], jmargins[p])
        else:
            assert np.isinf(margins[p]) == np.isinf(jmargins[p])
    assert n_match >= len(pairs) - 1


def test_bank_strictly_positive_detects_zero():
    rng = np.random.default_rng(3)
    bank = build_banks(_cores(rng, 1), uniform=True)[0]
    assert bank_strictly_positive(bank)
    bank.t_mi[0, 2] = 0.0
    assert not bank_strictly_positive(bank)


@pytest.mark.cuda
def test_oa_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch.ops.oa import oa_nats, oa_ref, pack_pairs
    rng = np.random.default_rng(11)
    banks = build_banks(_cores(rng), indices=[0, 1, 2], uniform=True)
    bt = bank_to_torch(banks[0], "cuda")
    pairs = [(int(rng.integers(0, bt.H)),
              rng.integers(0, 4, int(rng.integers(20, 90))).astype(np.int32))
             for _ in range(8)]
    pk = pack_pairs(bt, pairs)
    ck, sk = oa_nats(bt, *pk, Ldmax=96)
    cp, sp = oa_ref(bt, *pk)
    sk, sp = sk.cpu().numpy(), sp.cpu().numpy()
    off = pk[3].cpu().numpy()
    for t, (_, c) in enumerate(pairs):
        if sk[t, 0] >= GUARD:
            assert np.array_equal(ck.cpu().numpy()[off[t]:off[t] + len(c)],
                                  cp.cpu().numpy()[off[t]:off[t] + len(c)])
    np.testing.assert_allclose(sk[:, 1], sp[:, 1])


def _wide_case(M, seed):
    """One model of M states (build_banks pads M to a multiple of 128,
    the port adds the state-0 lane and pads to 32 lanes) and query
    fragments of its consensus."""
    alpha = ALPHABETS["dna"]
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, M)
    rows = np.array([np.where(rng.random(M) < 0.1, rng.integers(0, 4, M),
                              base) for _ in range(4)])
    core = build_hmm(rows.astype(np.uint8), alpha, "dna", name="wide")
    bank = build_banks([core], uniform=True)[0]
    pairs = []
    for _ in range(4):
        a = int(rng.integers(0, M - 200))
        q = base[a:a + int(rng.integers(80, 200))].copy()
        q[rng.random(len(q)) < 0.05] = rng.integers(0, 4)
        pairs.append((0, q.astype(np.int32)))
    return bank, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8191, 16384])
def test_oa_kernel_wide_models_match_plain(M):
    """Mp 8,224 and 16,416 (the 16,384-state cap): the working rows no
    longer fit in shared memory and live in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.oa import (ROW_BYTES, oa_nats, oa_ref,
                                        pack_pairs)
    bank, pairs = _wide_case(M, 5)
    bt = bank_to_torch(bank, "cuda")
    assert bt.Mp == -(-M // 128) * 128 + 32
    assert ROW_BYTES * bt.Mp > _build.SMEM_ROWS_MAX
    pk = pack_pairs(bt, pairs)
    ck, sk = oa_nats(bt, *pk, Ldmax=200)
    cp, sp = oa_ref(bt, *pk)
    ck, sk, cp, sp = (x.cpu().numpy() for x in (ck, sk, cp, sp))
    off = pk[3].cpu().numpy()
    np.testing.assert_array_equal(sk[:, 1], sp[:, 1])
    assert sk[:, 1].all()
    for t, (_, c) in enumerate(pairs):
        if sk[t, 0] >= GUARD:
            np.testing.assert_array_equal(ck[off[t]:off[t] + len(c)],
                                          cp[off[t]:off[t] + len(c)])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [384, 1408, 1536, 2688, 3968, 4000])
def test_oa_kernel_widths_match_plain(M):
    """Mp 416, 1,440, 1,568 and 2,720 (the main paths' and the bench
    grid's widths) and both sides of the dispatch boundary (Mp 4,000 on
    the warp-per-pair kernel, 4,128 on its cluster instance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch.ops.oa import oa_layout, oa_nats, oa_ref, pack_pairs
    bank, pairs = _wide_case(M, 9)
    bt = bank_to_torch(bank, "cuda")
    layout = oa_layout(bt.Mp)[0]
    assert layout == (0 if bt.Mp <= 4096 else 1)
    pk = pack_pairs(bt, pairs)
    ck, sk = oa_nats(bt, *pk, Ldmax=200)
    cp, sp = oa_ref(bt, *pk)
    ck, sk, cp, sp = (x.cpu().numpy() for x in (ck, sk, cp, sp))
    off = pk[3].cpu().numpy()
    np.testing.assert_array_equal(sk[:, 1], sp[:, 1])
    assert sk[:, 1].all()
    for t, (_, c) in enumerate(pairs):
        if sk[t, 0] >= GUARD:
            np.testing.assert_array_equal(ck[off[t]:off[t] + len(c)],
                                          cp[off[t]:off[t] + len(c)])
    fin = np.isfinite(sp[:, 0])
    np.testing.assert_array_equal(np.isfinite(sk[:, 0]), fin)
    assert np.abs(sk[fin, 0] - sp[fin, 0]).max(initial=0.0) < 1e-4
    # the total score Z (nats) from the Backward: f32 sums in another order
    np.testing.assert_allclose(sk[:, 2], sp[:, 2], rtol=1e-5)


@pytest.mark.cuda
def test_oa_kernel_split_launches_agree():
    """A small scratch budget cuts the pairs into one launch per CTA; the
    results equal one launch's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.oa import oa_nats, pack_pairs
    rng = np.random.default_rng(13)
    banks = build_banks(_cores(rng), indices=[0, 1, 2], uniform=True)
    bt = bank_to_torch(banks[0], "cuda")
    pairs = [(int(rng.integers(0, bt.H)),
              rng.integers(0, 4, int(rng.integers(20, 90))).astype(np.int32))
             for _ in range(24)]
    pk = pack_pairs(bt, pairs)
    n0 = _build.LAUNCHES["oa"]
    c1, s1 = oa_nats(bt, *pk)
    n1 = _build.LAUNCHES["oa"]
    c2, s2 = oa_nats(bt, *pk, budget=1)
    n2 = _build.LAUNCHES["oa"]
    assert n1 - n0 == 1 and n2 - n1 > 1
    assert torch.equal(c1, c2) and torch.equal(s1, s2)
