"""The port's flank wrapper around its warp-per-pair kernel
(witch_tpu_torch/ops/flank.py): the width dispatch (flank_layout), the
slot tables with the Backward chain's per-model invariant D_1, and the
length order with its write-back, held against the plain version, which
tests/test_torch_flank.py holds against the JAX scans."""

import numpy as np
import pytest
import torch

from witch_tpu_torch.device import BankTensors
from witch_tpu_torch.ops._plain import bck_chain, bck_chain_coeffs, shift_l
from witch_tpu_torch.ops.flank import (FLANK_WARPS, T_DD, T_MD, cta_queries,
                                       flank_layout, flank_rows_ref,
                                       flank_tables, smem_bytes)
from witch_tpu_torch.ops.forward import slot_index

from test_torch_flank import _toy

WIDTHS = [(416, (0, 1, 16, 512)), (1312, (0, 1, 48, 1536)),
          (1440, (0, 1, 48, 1536)), (1568, (0, 2, 32, 2048)),
          (2720, (0, 2, 48, 3072)), (8096, (1, 16, 16, 8192)),
          (16416, (1, 24, 24, 18432))]


@pytest.mark.parametrize("Mp,want", WIDTHS)
def test_flank_layout_by_width(Mp, want):
    """The warp-per-pair kernel at every width of the bench grid,
    amino500 and dna1k; the cluster instance at phase 2e's 8,000- and
    16,384-state models (tests/test_torch_wide.py holds every cluster
    boundary)."""
    got = flank_layout(Mp)
    assert got == want
    layout, G, npl, Mpad = got
    if layout == 0:
        assert Mpad == 32 * G * npl >= Mp and G <= FLANK_WARPS
        assert 32 * (G - 1) * npl < Mp              # no warp idle
        assert smem_bytes(G, Mpad) <= 232448 - 1024
    else:
        C = G // FLANK_WARPS
        assert Mpad == 32 * G * npl >= Mp and G == FLANK_WARPS * C
        assert smem_bytes(G, Mpad, C) <= 232448 - 1024


def _seeded_bank(Mp, seed, H=2, K=5):
    """Transitions and emissions of plain-chain shape with the padding of
    a real bank: states from M + 1 on are zero, t_dd of the last live
    state too."""
    rng = np.random.default_rng(seed)
    M = Mp - 32 - int(rng.integers(0, 64))
    tr = rng.uniform(0.05, 0.9, (H, 8, Mp)).astype(np.float32)
    tr[:, :, M + 1:] = 0.0
    tr[:, T_DD, M] = 0.0
    em = rng.uniform(0.1, 3.0, (H, K, Mp)).astype(np.float32)
    em[:, :, M + 1:] = 0.0
    em[:, :, 0] = 0.0
    return BankTensors(em=torch.from_numpy(em), trans=torch.from_numpy(tr),
                       M=np.full(H, M, np.int32), pad_code=K - 1)


def _unslot(t, G, npl):
    """Slot layout [..., Mpad] back to k order."""
    k = slot_index(t.shape[-1], G, npl)
    out = torch.empty_like(t)
    out[..., torch.from_numpy(k)] = t
    return out


@pytest.mark.parametrize("Mp", [m for m, w in WIDTHS if w[0] == 0])
def test_slot_tables_chain_split(Mp):
    """D_c + E D_1 from the kernel's tables equals the plain Backward
    chain bck_chain(shift_l(mne) t_dm + E) to 1e-6 relative on seeded
    rows, and the tables hold the bank's values in forward's slots."""
    _, G, npl, Mpad = flank_layout(Mp)
    bt = _seeded_bank(Mp, Mp)
    em_t, tr_t, d1_t = flank_tables(bt, G, npl)
    assert flank_tables(bt, G, npl)[2] is d1_t       # cached on the bank
    tr = _unslot(tr_t, G, npl).double()
    assert torch.equal(_unslot(em_t, G, npl)[..., :Mp], bt.em)
    assert not _unslot(em_t, G, npl)[..., Mp:].any()
    live = [r for r in range(8) if r not in (T_MD, T_DD)]
    assert torch.equal(tr[:, live, :Mp].float(), bt.trans[:, live])
    assert not tr[..., Mp:].any()
    d1 = _unslot(d1_t, G, npl).double()
    rng = np.random.default_rng(Mp + 1)
    n = 4
    mne = torch.from_numpy(rng.uniform(0, 2, (bt.H, n, Mp)))
    mne[..., bt.M[0] + 1:] = 0.0
    E = torch.from_numpy(rng.uniform(0.01, 5, (bt.H, n, 1)))
    tdm = bt.trans[:, 5, None, :].double()
    tdd = bt.trans[:, T_DD, None, :].double()
    ref = bck_chain(shift_l(mne) * tdm + E, bck_chain_coeffs(tdd))
    # D_c over the padded row, right to left, as the kernel's lanes run it
    mp = torch.zeros((bt.H, n, Mpad + 1), dtype=torch.float64)
    mp[..., :Mp] = mne
    Dc = torch.zeros((bt.H, n, Mpad + 1), dtype=torch.float64)
    for k in range(Mpad - 1, -1, -1):
        Dc[..., k] = mp[..., k + 1] * tr[:, None, 5, k] \
            + tr[:, None, T_DD, k] * Dc[..., k + 1]
    got = Dc[..., :Mp] + E * d1[:, None, :Mp]
    rel = ((got - ref).abs() / ref.abs()).max()
    assert float(rel) < 1e-6


@pytest.mark.parametrize("wp,Q", [(8, 1), (8, 13), (4, 40), (2, 7), (1, 5)])
def test_cta_queries_order_and_write_back(wp, Q):
    """Each query in one slot, longest first, -1 only past the last;
    the plain version run slot by slot and written back at each slot's
    query equals it run in the caller's order."""
    rng = np.random.default_rng(Q * 10 + wp)
    lens = rng.integers(1, 30, Q).astype(np.int32)
    lens[rng.integers(0, Q)] = 30
    slots = cta_queries(torch.from_numpy(lens), wp).numpy()
    assert len(slots) % wp == 0 and len(slots) - Q < wp
    assert sorted(slots[:Q].tolist()) == list(range(Q))
    assert (slots[Q:] == -1).all()
    assert np.all(np.diff(lens[slots[:Q]]) <= 0)
    assert np.array_equal(slots[:Q][lens[slots[:Q]] == 30],
                          np.flatnonzero(lens == 30))        # stable
    bank, qcodes, qlens, _ = _toy()
    from witch_tpu_torch.device import bank_to_torch
    bt = bank_to_torch(bank, "cpu")
    c, ln = torch.from_numpy(qcodes), torch.from_numpy(qlens)
    want = flank_rows_ref(bt, c, ln)
    s = cta_queries(ln, wp)
    s = s[s >= 0].long()
    got = flank_rows_ref(bt, c[s], ln[s])
    for w, g in zip(want, got):
        back = torch.empty_like(w)
        back[s] = g
        torch.testing.assert_close(back, w, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("M,Mp", [(300, 416), (1200, 1312), (1400, 1440),
                                  (1500, 1568), (2600, 2720)])
def test_warp_kernel_matches_plain(M, Mp):
    """The warp-per-pair kernel at G = 1 (Mp 416, 1,312, 1,440) and G = 2
    (Mp 1,568, 2,720) against the plain version on two models and ragged
    queries: lengths 1 to the longest, more queries than a CTA's pairs.
    |dfwd| <= 5e-3 nats and |drows| <= 2e-3, the JAX package's own bounds
    against f64 (tests/test_flank_device.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu.hmm.bank import build_banks
    from witch_tpu_torch import _build
    from witch_tpu_torch.device import bank_to_torch
    from witch_tpu_torch.ops.flank import flank_rows
    from test_torch_forward import model_and_fragments
    lens = [1, 280, 1, 2, 17, 64, 1, 129, 255, 3, 1, 280, 77]
    core, codes, lens = model_and_fragments(M, M, lens)
    core2, _, _ = model_and_fragments(M - 20, M + 1, [5])
    bank = build_banks([core, core2], uniform=True, n_buckets=2)[0]
    bt = bank_to_torch(bank, "cuda")
    assert bt.Mp == Mp and flank_layout(Mp)[0] == 0
    c = torch.from_numpy(codes).cuda()
    ln = torch.from_numpy(lens).cuda()
    _build.reset_launches()
    got = flank_rows(bt, c, ln)
    assert _build.LAUNCHES["flank"] == 1 and _build.KERNEL_MS["flank"] > 0
    ref = flank_rows_ref(bt, c, ln)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all()
    assert float((got[0] - ref[0]).abs().max()) <= 5e-3
    for a, b in zip(got[1:], ref[1:]):
        assert float((a - b).abs().max()) <= 2e-3
    for q, L in enumerate(lens):                 # the tail is zero
        assert not any(x[q, :, L + 1:].any() for x in got[1:])


@pytest.mark.cuda
def test_warp_kernel_launches_split_by_scratch(monkeypatch):
    """A scratch budget of one CTA's pairs splits the grid into one
    launch per group of query slots; the rows equal those of one launch
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu.hmm.bank import build_banks
    from witch_tpu_torch import _build
    from witch_tpu_torch.device import bank_to_torch
    import witch_tpu_torch.ops.flank as FL
    from test_torch_forward import model_and_fragments
    lens = [40, 1, 77, 12, 90, 5, 64, 33, 2, 90, 17, 50, 8, 71, 1, 29, 44]
    core, codes, lens = model_and_fragments(300, 7, lens)
    core2, _, _ = model_and_fragments(280, 8, [5])
    bt = bank_to_torch(build_banks([core, core2], uniform=True,
                                   n_buckets=2)[0], "cuda")
    c = torch.from_numpy(codes).cuda()
    ln = torch.from_numpy(lens).cuda()
    one = FL.flank_rows(bt, c, ln)
    _, G, _, _ = FL.flank_layout(bt.Mp)
    wp = FL.FLANK_WARPS // G
    monkeypatch.setattr(FL, "SCRATCH_BYTES",
                        4 * wp * bt.H * FL.spec_floats(codes.shape[1]))
    _build.reset_launches()
    split = FL.flank_rows(bt, c, ln)
    assert _build.LAUNCHES["flank"] == -(-len(lens) // wp)
    for a, b in zip(one, split):
        assert torch.equal(a, b)
