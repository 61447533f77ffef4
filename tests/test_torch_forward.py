"""Port's Forward scoring (plain version on the CPU) vs the JAX Pallas
kernel in interpret mode and vs the native f64 Forward, on seeded
inputs handed to both sides as numpy arrays."""

import numpy as np
import pytest
import torch

from witch_tpu.core.alphabet import DNA
from witch_tpu.hmm.bank import build_banks
from witch_tpu.hmm.build import build_hmm, quantize_like_text
from witch_tpu.hmm.profile import configure, null1_score
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.ops.forward import (LN2, forward_bits, forward_nats,
                                         forward_nats_ref, fwd_layout,
                                         length_order, slot_index)

try:
    from witch_tpu.native import _domaindef
except ImportError:     # pragma: no cover
    _domaindef = None

LETTERS = np.array(list("ACGT"))


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


def model_and_fragments(M, seed, lens):
    """One synthetic DNA model of M states and query fragments of its
    consensus with the given lengths (5 % point mutations)."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, M)
    rows = []
    for _ in range(6):
        s = base.copy()
        mut = r.random(M) < 0.1
        s[mut] = r.integers(0, 4, mut.sum())
        rows.append(DNA.encode("".join(LETTERS[s])))
    core = quantize_like_text(build_hmm(np.array(rows), DNA, "dna"))
    codes = np.zeros((len(lens), max(lens)), np.int32)
    for i, L in enumerate(lens):
        a = int(r.integers(0, M - L + 1))
        q = base[a:a + L].copy()
        mut = r.random(L) < 0.05
        q[mut] = r.integers(0, 4, mut.sum())
        codes[i, :L] = q
    return core, codes, np.asarray(lens, np.int32)


def grid(seed, n_q=9):
    cores = [synth_core(36, 10, seed), synth_core(70, 10, seed + 1),
             synth_core(130, 8, seed + 2)]
    banks = build_banks(cores, uniform=True, n_buckets=2)
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 4, int(rng.integers(15, 120))).astype(np.int32)
          for _ in range(n_q)]
    lens = np.array([len(q) for q in qs], np.int32)
    codes = np.zeros((n_q, lens.max()), np.int32)
    for i, q in enumerate(qs):
        codes[i, :len(q)] = q
    return cores, banks, qs, codes, lens


def native_bits(core, qs):
    p = configure(core, multihit=True)
    args = [np.ascontiguousarray(p.msc, np.float64)] + [
        np.ascontiguousarray(getattr(p, a), np.float64)
        for a in ("t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm", "t_dd",
                  "bm")]
    f = np.asarray(_domaindef.forward_targets_exact(*args, qs, 1))
    return (f - np.array([null1_score(len(q)) for q in qs])) / np.log(2.0)


@pytest.mark.skipif(_domaindef is None, reason="native engine unavailable")
@pytest.mark.parametrize("seed", [2, 31])
def test_forward_matches_native(seed):
    cores, banks, qs, codes, lens = grid(seed)
    for b in banks:
        got = forward_bits(bank_to_torch(b, "cpu"), codes, lens)
        for j, idx in enumerate(b.hmm_indices):
            np.testing.assert_allclose(got[:, j],
                                       native_bits(cores[idx], qs),
                                       atol=1e-3)


@pytest.mark.parametrize("seed", [5])
def test_forward_matches_pallas_interpret(seed):
    from witch_tpu.ops.pallas_forward import pallas_forward_bits
    _, banks, _, codes, lens = grid(seed, n_q=6)
    for b in banks:
        got = forward_bits(bank_to_torch(b, "cpu"), codes, lens)
        ref = pallas_forward_bits(b, codes, lens, QT=8, interpret=True,
                                  group_by_length=False)
        np.testing.assert_allclose(got, ref, atol=1e-3)


def test_no_padding_rows_enter_the_score():
    """Each query runs exactly its own length: trailing codes beyond
    qlen (any value) and a wider code matrix change nothing."""
    _, banks, _, codes, lens = grid(4, n_q=5)
    bt = bank_to_torch(banks[0], "cpu")
    a = forward_bits(bt, codes, lens)
    wide = np.full((codes.shape[0], codes.shape[1] + 40), 2, np.int32)
    for i, L in enumerate(lens):
        wide[i, :L] = codes[i, :L]
    np.testing.assert_array_equal(forward_bits(bt, wide, lens), a)


def test_bank_to_torch_round_trip():
    _, banks, _, _, _ = grid(6, n_q=1)
    b = banks[-1]
    bt = bank_to_torch(b, "cpu")
    Mp1 = b.em_odds.shape[1]
    assert bt.Mp % 32 == 0 and bt.Mp >= Mp1
    np.testing.assert_array_equal(
        bt.em[:, :, :Mp1].numpy(), np.transpose(b.em_odds, (0, 2, 1)))
    assert not bt.em[:, :, Mp1:].any() and not bt.trans[:, :, Mp1:].any()
    for r, a in enumerate(("t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm",
                           "t_dd", "bm")):
        np.testing.assert_array_equal(bt.trans[:, r, :Mp1].numpy(),
                                      getattr(b, a))
    np.testing.assert_array_equal(bt.M, b.M)
    assert not np.abs(b.em_odds[:, :, bt.pad_code]).any()
    assert bank_to_torch(b, "cpu") is bt          # content-hash cache


def test_wrapper_on_cpu_is_the_plain_version():
    _, banks, _, codes, lens = grid(8, n_q=3)
    bt = bank_to_torch(banks[0], "cpu")
    c, l = torch.from_numpy(codes), torch.from_numpy(lens)
    torch.testing.assert_close(forward_nats(bt, c, l),
                               forward_nats_ref(bt, c, l))


def test_length_order_and_scatter_back():
    """Queries of lengths 1..Lmax, shuffled, go through the wrapper in
    length order and come back in their original order, equal to the
    plain version on the caller's order."""
    _, banks, _, _, _ = grid(12, n_q=1)
    rng = np.random.default_rng(12)
    Lmax = 40
    lens = rng.permutation(np.arange(1, Lmax + 1)).astype(np.int32)
    codes = rng.integers(0, 4, (Lmax, Lmax)).astype(np.int32)
    order = length_order(torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(lens[order], np.arange(Lmax, 0, -1))
    c, l = torch.from_numpy(codes), torch.from_numpy(lens)
    for b in banks:
        bt = bank_to_torch(b, "cpu")
        torch.testing.assert_close(forward_nats(bt, c, l),
                                   forward_nats_ref(bt, c, l),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("Mp,layout", [(416, 0), (1312, 0), (1568, 0),
                                       (2720, 0), (8224, 1), (16416, 1)])
def test_kernel_layout_covers_each_state_once(Mp, layout):
    got, G, npl, Mpad = fwd_layout(Mp)
    assert got == layout and Mpad == 32 * G * npl >= Mp
    k = slot_index(Mp, G, npl)
    np.testing.assert_array_equal(np.sort(k[k >= 0]), np.arange(Mp))
    # a lane's states are contiguous: slot (j*G + g)*32 + lane
    s = np.flatnonzero(k == Mp - 1)[0]
    lane, g, j = s % 32, (s // 32) % G, s // (32 * G)
    assert (g * 32 + lane) * npl + j == Mp - 1


@pytest.mark.cuda
@pytest.mark.parametrize("M,Mp", [(300, 416), (1200, 1312), (2600, 2720),
                                  (16384, 16416)])
def test_kernel_matches_plain_at_main_path_widths(M, Mp):
    """Each width's layout against the plain version within 1e-3 bits,
    on a tile that mixes L = 1 with the longest query."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    lens = [1, 280, 1, 2, 17, 64, 1, 129, 255, 3, 1, 279]
    core, codes, lens = model_and_fragments(M, M, lens)
    bank = build_banks([core], uniform=True, n_buckets=2)[0]
    bc = bank_to_torch(bank, "cuda")
    assert bc.Mp == Mp
    c = torch.from_numpy(codes).cuda()
    l = torch.from_numpy(lens).cuda()
    got = forward_nats(bc, c, l)
    ref = forward_nats_ref(bc, c, l)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float(((got - ref).abs() / LN2).max()) <= 1e-3


@pytest.mark.cuda
def test_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, banks, _, codes, lens = grid(9, n_q=7)
    for b in banks:
        bc = bank_to_torch(b, "cuda")
        c = torch.from_numpy(codes).cuda()
        l = torch.from_numpy(lens).cuda()
        got = forward_nats(bc, c, l).cpu()
        ref = forward_nats_ref(bc, c, l).cpu()
        torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
