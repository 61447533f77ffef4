"""The port's pair-HMM forward log-odds (witch_tpu_torch/ops/pairhmm.py)
against the JAX package's XLA version and the float64 reference, and the
port's device anchor embedding against the JAX package's.

Tolerances: plain against JAX within 1e-3 nats (both f32 with a row
rescale; they differ in the order of the in-row gap sums and in the sum
of the log scales, f64 in the port, f32 in JAX); plain against the f64
reference within 5e-3 nats (the bar of tests/test_pairhmm_forward.py);
embeddings within 2e-4 per residue (the same file's bar); kernel against
plain within 2e-4 per residue over the scenario-A-like lengths."""

import numpy as np
import pytest
import torch

from witch_tpu.backbone_consistency import _emission_odds
from witch_tpu.core.alphabet import ALPHABETS
from witch_tpu.ops.pairhmm_forward import (pairhmm_forward_logodds,
                                           pairhmm_forward_logodds_np)
from witch_tpu_torch.ops.pairhmm import (pairhmm_forward_logodds as
                                         port_logodds,
                                         pairhmm_forward_logodds_np as
                                         port_np,
                                         pairhmm_forward_logodds_plain)


def _batch(seed, P, LA, LB, lo_a, lo_b, alphabet="dna"):
    rng = np.random.default_rng(seed)
    al = ALPHABETS[alphabet]
    cA = rng.integers(0, al.K, (P, LA)).astype(np.int32)
    cB = rng.integers(0, al.K, (P, LB)).astype(np.int32)
    cA[0, 5] = al.encode("N" if alphabet == "dna" else "X")[0]
    lA = rng.integers(lo_a, LA + 1, P).astype(np.int32)
    lB = rng.integers(lo_b, LB + 1, P).astype(np.int32)
    return cA, lA, cB, lB


def _plain(cA, lA, cB, lB, em, delta, eps):
    return pairhmm_forward_logodds_plain(
        *(torch.from_numpy(x) for x in (cA, lA, cB, lB)),
        torch.from_numpy(em.astype(np.float32)), delta, eps).numpy()


@pytest.mark.parametrize("shape", [
    # tests/test_pairhmm_forward.py's shapes, and lengths 300-800
    (6, 80, 64, 30, 25, 0.12, 0.01, "dna"),
    (4, 800, 700, 300, 300, 0.3, 0.02, "dna"),
    (3, 500, 640, 300, 400, 0.3, 0.02, "amino")],
    ids=["small", "dna_300_800", "amino_300_640"])
def test_plain_matches_jax(shape):
    P, LA, LB, lo_a, lo_b, match_p, delta, alpha = shape
    em = _emission_odds(ALPHABETS[alpha], match_p)
    cA, lA, cB, lB = _batch(P + LA, P, LA, LB, lo_a, lo_b, alpha)
    jax_out = np.asarray(pairhmm_forward_logodds(cA, lA, cB, lB, em,
                                                 delta, 0.75))
    got = _plain(cA, lA, cB, lB, em, delta, 0.75)
    assert got.dtype == np.float32 and got.shape == (P,)
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-3)


def test_plain_matches_f64_reference():
    em = _emission_odds(ALPHABETS["dna"], 0.12)
    cA, lA, cB, lB = _batch(0, 6, 80, 64, 30, 25)
    got = _plain(cA, lA, cB, lB, em, 0.01, 0.75)
    for p in range(6):
        ref = pairhmm_forward_logodds_np(cA[p, :lA[p]], cB[p, :lB[p]],
                                         em, 0.01, 0.75)
        assert port_np(cA[p, :lA[p]], cB[p, :lB[p]], em, 0.01, 0.75) \
            == ref
        assert abs(got[p] - ref) < 5e-3, (p, got[p], ref)


def test_identical_scores_above_shuffled():
    em = _emission_odds(ALPHABETS["dna"], 0.3)
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, 120).astype(np.int32)
    shuf = a.copy()
    rng.shuffle(shuf)
    lens = np.full(2, 120, np.int32)
    out = _plain(np.stack([a, a]), lens, np.stack([a, shuf]), lens, em,
                 0.01, 0.75)
    assert out[0] > out[1] + 5.0


def _codes(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [np.ascontiguousarray(rng.integers(0, 4, rng.integers(lo, hi)),
                                 np.int32) for _ in range(n)]


@pytest.mark.parametrize("chunk", [4, 1024])
def test_device_embedding_matches_jax(chunk):
    """The port's _device_embedding (plain version on the CPU) against
    the JAX package's, through the length sort and the chunks."""
    from witch_tpu.backbone_consistency import _device_embedding as jax_emb
    from witch_tpu_torch.backbone_consistency import _device_embedding
    em = _emission_odds(ALPHABETS["dna"], 0.30)
    codes = _codes(3, 7, 40, 90)
    anchors = [0, 4]
    want = jax_emb(codes, anchors, em, 0.02, 0.75, chunk=chunk)
    got = _device_embedding(codes, anchors, em, 0.02, 0.75, "cpu",
                            chunk=chunk)
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_anchor_embedding_device_flag():
    """anchor_embedding(use_device=True) takes the device path on the
    caller's device, WITCH_TPU_DEVICE_EMBED=1 likewise, and equals the
    JAX package's on the same input; without a card and without a device
    it raises instead of running on the CPU."""
    from witch_tpu.backbone_consistency import anchor_embedding as jax_ae
    from witch_tpu_torch.backbone_consistency import anchor_embedding
    from witch_tpu_torch.core.alphabet import ALPHABETS as PORT_AL
    codes = _codes(5, 9, 50, 80)
    want = jax_ae(codes, ALPHABETS["dna"], n_anchors=3, use_device=True)
    got = anchor_embedding(codes, PORT_AL["dna"], n_anchors=3,
                           use_device=True, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            anchor_embedding(codes, PORT_AL["dna"], n_anchors=3,
                             use_device=True)


def test_kernel_layout_by_width():
    """Where the kernel keeps a warp's rows and B's codes, by B's width:
    both in shared memory at the repo's lengths, then the rows in device
    memory, then both."""
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.pairhmm import PH_WARPS, pairhmm_layout
    C = 17
    assert pairhmm_layout(C, 1400) == (True, True)
    assert pairhmm_layout(C, 20000) == (False, True)
    assert pairhmm_layout(C, 60000) == (False, False)
    free = _build.SMEM_ROWS_MAX - 4 * C * C
    widest = (free - 12 * PH_WARPS) // (13 * PH_WARPS)
    assert pairhmm_layout(C, widest) == (True, True)
    assert pairhmm_layout(C, widest + 1) == (False, True)


def test_cpu_tensors_take_the_plain_version():
    from witch_tpu_torch import _build
    em = _emission_odds(ALPHABETS["dna"], 0.12)
    cA, lA, cB, lB = _batch(2, 3, 40, 30, 10, 10)
    _build.reset_launches()
    got = port_logodds(*(torch.from_numpy(x) for x in (cA, lA, cB, lB)),
                       torch.from_numpy(em), 0.01, 0.75)
    assert _build.LAUNCHES["pairhmm"] == 0
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(cA, lA, cB, lB, em, 0.01, 0.75))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    """The kernel against the plain version on the card, at scenario-A
    lengths (1,200-1,400 DNA residues, 64 pairs; rows and codes in
    shared memory), with rows too wide for shared memory (20,000 columns:
    rows in a device buffer, codes in shared memory) and wider still
    (60,000: both in device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pair-HMM kernel has no CPU "
                    "mode")
    from witch_tpu_torch import _build
    for alpha, P, LA, LB, lo in (("dna", 64, 1400, 1400, 1200),
                                 ("amino", 8, 300, 20000, 200),
                                 ("dna", 4, 100, 60000, 90)):
        em = _emission_odds(ALPHABETS[alpha], 0.3)
        cA, lA, cB, lB = _batch(7, P, LA, LB, lo, lo, alpha)
        args = [torch.from_numpy(x).cuda() for x in (cA, lA, cB, lB)]
        emt = torch.from_numpy(em.astype(np.float32)).cuda()
        n0 = _build.LAUNCHES["pairhmm"]
        k = port_logodds(*args, emt, 0.02, 0.75)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["pairhmm"] == n0 + 1
        p = pairhmm_forward_logodds_plain(*args, emt, 0.02, 0.75)
        norm = np.minimum(lA, lB).astype(np.float64)
        err = np.abs(k.cpu().numpy() - p.cpu().numpy()) / norm
        assert np.isfinite(k.cpu().numpy()).all()
        assert err.max() < 2e-4, (alpha, err.max())
