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


@pytest.mark.parametrize("chunk", [4, 1024, None])
def test_device_embedding_matches_jax(chunk):
    """The port's _device_embedding (plain version on the CPU) against
    the JAX package's, through the length sort and the chunks (None: every
    pair in one call, the port's default, against the JAX package's
    default chunk of 1,024)."""
    from witch_tpu.backbone_consistency import _device_embedding as jax_emb
    from witch_tpu_torch.backbone_consistency import _device_embedding
    em = _emission_odds(ALPHABETS["dna"], 0.30)
    codes = _codes(3, 7, 40, 90)
    anchors = [0, 4]
    want = jax_emb(codes, anchors, em, 0.02, 0.75, chunk=chunk or 1024)
    got = _device_embedding(codes, anchors, em, 0.02, 0.75, "cpu",
                            chunk=chunk)
    assert got.shape == (7, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_device_embedding_long_matches_jax():
    """The port's _device_embedding on sequences of 1,600-1,800 residues
    (scenario A's long input, whose anchors take the kernel's wide
    layout on the card) against the JAX package's, within 2e-4."""
    from witch_tpu.backbone_consistency import _device_embedding as jax_emb
    from witch_tpu_torch.backbone_consistency import _device_embedding
    from witch_tpu_torch.ops.pairhmm import pairhmm_layout
    em = _emission_odds(ALPHABETS["dna"], 0.30)
    rng = np.random.default_rng(18)
    root = rng.integers(0, 4, 1800)
    codes = []
    for _ in range(7):
        s = np.where(rng.random(1800) < 0.15, rng.integers(0, 4, 1800),
                     root)
        cut = rng.integers(0, 200)
        codes.append(np.ascontiguousarray(s[cut // 2:1800 - (cut + 1) // 2],
                                          np.int32))
    lens = [len(c) for c in codes]
    assert 1600 <= min(lens) and max(lens) <= 1800
    anchors = [1, 3, 6]
    assert pairhmm_layout(em.shape[0], max(lens[a] for a in anchors))[0] \
        == 2
    want = jax_emb(codes, anchors, em, 0.02, 0.75)
    got = _device_embedding(codes, anchors, em, 0.02, 0.75, "cpu")
    assert got.shape == (7, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_device_embedding_one_call_equals_chunks(monkeypatch):
    """Every pair in one call (the default) gives exactly the E of chunks
    of 1,024 and of 5 on the CPU: each pair's log-odds depends only on
    its own codes and lengths, across unequal lengths and more pairs
    than a chunk."""
    import witch_tpu_torch.ops.pairhmm as ph
    from witch_tpu_torch.backbone_consistency import _device_embedding
    em = _emission_odds(ALPHABETS["dna"], 0.30)
    codes = _codes(11, 9, 20, 70)
    anchors = [2, 7, 5]
    calls = []
    orig = ph.pairhmm_forward_logodds

    def counted(*a):
        calls.append(a[0].shape)
        return orig(*a)

    monkeypatch.setattr(ph, "pairhmm_forward_logodds", counted)
    one = _device_embedding(codes, anchors, em, 0.02, 0.75, "cpu")
    assert calls == [(27, max(len(c) for c in codes))]
    for chunk in (1024, 5):
        got = _device_embedding(codes, anchors, em, 0.02, 0.75, "cpu",
                                chunk=chunk)
        np.testing.assert_array_equal(got, one)
    assert len(calls) == 1 + 1 + 6


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
    """Which kernel runs, by B's width: the register kernel up to 32 x 48
    - 1 = 1,535 columns (the repo's anchors, 1,271-1,357 residues, at CH
    44), the wide layout from 1,536 (scenario A's long anchors, ~1,670,
    and dnawide's, ~7,100) up to its cap PH_WIDE_LB_MAX, then the first
    version; the first version's own steps (rows and codes in shared
    memory, then its rows in device memory, then both) through
    first_version_smem."""
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.pairhmm import (PH_CH, PH_WARPS,
                                             PH_WIDE_LB_MAX,
                                             first_version_smem,
                                             pairhmm_layout)
    C = 17
    assert pairhmm_layout(C, 1357) == (0, 44, 1)
    widest = 32 * PH_CH[-1] - 1
    assert pairhmm_layout(C, widest) == (0, PH_CH[-1], 1)
    for LB in (widest + 1, widest + 2, 1686, 7100, PH_WIDE_LB_MAX):
        lay, ch, g = pairhmm_layout(C, LB)
        assert lay == 2 and 32 * g * ch >= LB + 1 > 32 * (g - 1) * ch, LB
    assert PH_WIDE_LB_MAX >= 8191
    # CH 24 at every width, G = ceil((LB + 1) / 768)
    assert [pairhmm_layout(C, LB) for LB in (1536, 1537, 2303, 2304, 7100,
                                             PH_WIDE_LB_MAX)] == [
        (2, 24, 3), (2, 24, 3), (2, 24, 3), (2, 24, 4), (2, 24, 10),
        (2, 24, 11)]
    for LB in (PH_WIDE_LB_MAX + 1, 20000, 60000):
        assert pairhmm_layout(C, LB) == (1, 0, 0)
    assert first_version_smem(C, widest + 1) == (True, True)
    assert first_version_smem(C, 20000) == (False, True)
    assert first_version_smem(C, 60000) == (False, False)
    free = _build.SMEM_ROWS_MAX - 4 * C * C
    widest_smem = (free - 12 * PH_WARPS) // (13 * PH_WARPS)
    assert first_version_smem(C, widest_smem) == (True, True)
    assert first_version_smem(C, widest_smem + 1) == (False, True)
    # the first version's own steps at the register kernel's widths
    assert first_version_smem(C, 1400) == (True, True)
    assert first_version_smem(C, widest) == (True, True)
    # the register and wide kernels hold B's codes as byte offsets 4 c:
    # C <= 63
    assert pairhmm_layout(63, 100) == (0, 8, 1)
    assert pairhmm_layout(63, 7100)[0] == 2
    assert pairhmm_layout(64, 100) == (1, 0, 0)
    assert pairhmm_layout(64, 7100) == (1, 0, 0)


@pytest.mark.parametrize("ch", list(range(8, 49, 4)))
def test_register_layout_at_each_boundary(ch):
    """LB = 32 CH - 1 is the widest B a CH instance takes (LB + 1 columns
    from j = 0); 32 CH and 32 CH + 1 go to the next instance, past the
    last to the wide layout; the instance below stops at 32 (CH - 4)
    - 1."""
    from witch_tpu_torch.ops.pairhmm import PH_CH, pairhmm_layout
    assert ch in PH_CH
    C = 17
    nxt = [c for c in PH_CH if c > ch]
    assert pairhmm_layout(C, 32 * ch - 1) == (0, ch, 1)
    for LB in (32 * ch, 32 * ch + 1):
        if nxt:
            assert pairhmm_layout(C, LB) == (0, nxt[0], 1)
        else:
            assert pairhmm_layout(C, LB)[0] == 2
    if ch > PH_CH[0]:
        assert pairhmm_layout(C, 32 * (ch - 4)) == (0, ch, 1)
    else:
        assert pairhmm_layout(C, 0) == (0, ch, 1)


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


def _wide_steps(C=4):
    """The widths where the wide layout's pick (CH, G) changes, from
    1,536 to its cap: each first width of a pick and the width before."""
    from witch_tpu_torch.ops.pairhmm import PH_WIDE_LB_MAX, pairhmm_layout
    out, prev = [], None
    for LB in range(32 * 48, PH_WIDE_LB_MAX + 1):
        pick = pairhmm_layout(C, LB)
        if pick != prev:
            out += [LB - 1, LB] if prev else [LB]
            prev = pick
    return sorted(set(out + [PH_WIDE_LB_MAX]))


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(monkeypatch):
    """The kernels against the plain version on the card: the register
    kernel at every CH instance, B at its widest (LB = 32 CH - 1, lengths
    down to the instance below), and at scenario-A lengths (1,200-1,400
    DNA residues, 64 pairs) also the first version (first_version=True)
    against it, and at t_gg + t_mg > 1 (Y past B's end kept out of the
    row max); the wide layout at 1,536 and 1,537, at each step of its
    pick (CH, G), at 7,100 (dnawide's anchors) and at its cap, with
    pairs whose B ends more than a warp's columns before the launch's
    (warps past B), at eps 0.99 (the carry across warps), and every wide
    instance at its most warps; the first version where rows are wider
    than the wide layout's cap (8,192 and 20,000: rows in a device
    buffer) and wider still (60,000: rows and codes in device memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pair-HMM kernel has no CPU "
                    "mode")
    import witch_tpu_torch.ops.pairhmm as ph
    from witch_tpu_torch import _build
    # (alphabet, pairs, LA, LB, least len A, least len B, first version,
    #  delta, eps, forced (CH, G) of the wide layout)
    cases = [("dna", 6, 3 * ch, 32 * ch - 1, 1, 32 * ch - 128, False, 0.02,
              0.75, None) for ch in ph.PH_CH]
    cases += [("dna", 64, 1400, 1400, 1200, 1200, False, 0.02, 0.75, None),
              ("dna", 64, 1400, 1400, 1200, 1200, True, 0.02, 0.75, None),
              # t_gg + t_mg > 1: Y past LB would exceed the row's max
              ("dna", 16, 600, 639, 300, 500, False, 0.3, 0.75, None),
              ("amino", 8, 300, 1536, 200, 1200, False, 0.02, 0.75, None),
              ("dna", 16, 400, 1686, 300, 1647, False, 0.02, 0.75, None),
              ("dna", 16, 400, 1686, 300, 1647, False, 0.02, 0.99, None),
              ("dna", 8, 300, 7100, 200, 2000, False, 0.02, 0.75, None),
              ("dna", 8, 300, 7100, 200, 6800, False, 0.02, 0.99, None),
              ("dna", 8, 200, 8192, 100, 8000, False, 0.02, 0.75, None),
              ("amino", 8, 300, 20000, 200, 200, False, 0.02, 0.75, None),
              ("dna", 4, 100, 60000, 90, 90, False, 0.02, 0.75, None)]
    cases += [("dna", 4, 120, LB, 60, max(1, LB - 700), False, 0.02, 0.75,
               None) for LB in _wide_steps()]
    cases += [("dna", 4, 120, min(ph.PH_WIDE_LB_MAX,
                                  32 * ph.phw_gmax(ch) * ch - 1), 60, 1500,
               False, 0.02, 0.75, (ch, ph.phw_gmax(ch))) for ch in ph.PHW_CH]
    pick = ph.pairhmm_layout
    for alpha, P, LA, LB, lo_a, lo_b, first, delta, eps, forced in cases:
        em = _emission_odds(ALPHABETS[alpha], 0.3)
        cA, lA, cB, lB = _batch(7, P, LA, LB, lo_a, max(1, lo_b), alpha)
        args = [torch.from_numpy(x).cuda() for x in (cA, lA, cB, lB)]
        emt = torch.from_numpy(em.astype(np.float32)).cuda()
        want = (2,) + forced if forced else pick(em.shape[0], LB)
        monkeypatch.setattr(ph, "pairhmm_layout", lambda C, L: want)
        n0 = _build.LAUNCHES["pairhmm"]
        k = port_logodds(*args, emt, delta, eps, first_version=first)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["pairhmm"] == n0 + 1
        p = pairhmm_forward_logodds_plain(*args, emt, delta, eps)
        norm = np.minimum(lA, lB).astype(np.float64)
        err = np.abs(k.cpu().numpy() - p.cpu().numpy()) / norm
        assert np.isfinite(k.cpu().numpy()).all()
        assert err.max() < 2e-4, (alpha, LB, first, want, eps, err.max())
        if first:
            reg = port_logodds(*args, emt, delta, eps).cpu().numpy()
            assert want[0] == 0 and np.abs(reg - k.cpu().numpy()).max() \
                <= 1e-4, "register kernel vs the first version"


def _bench_tool():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "witch_pairhmm_bench", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "witch_tpu_torch", "tools", "pairhmm_bench.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_bench_tool_reads_ptxas_and_occupancy():
    """tools/pairhmm_bench.py's reading of nvcc -Xptxas -v (which
    chip_smoke.py 5c and 5w check for spills) and the warps a SM that
    registers allow on sm_90 (each scheduler's 16,384 registers,
    allocated per warp in units of 256; the wide instances' counted a
    warp at a time, the CTAs of G warps fitting that many over G)."""
    tool = _bench_tool()
    reg = "_Z18pairhmm_reg_kernelILi44EEvPKiS1_PKhS1_PKfPfiiiffff"
    first = "_Z14pairhmm_kernelPKiS0_PKhS0_PKfPfS5_iiiiiffff"
    wide = "_Z19pairhmm_wide_kernelILi24EEvPKiS1_PKhS1_PKfPfiiiiffff"
    text = "\n".join([
        "ptxas info    : Compiling entry function '%s' for 'sm_90a'" % wide,
        "ptxas info    : Function properties for %s" % wide,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 126 registers, 432 bytes cmem[0]",
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '%s' for 'sm_90a'" % reg,
        "ptxas info    : Function properties for %s" % reg,
        "    40 bytes stack frame, 116 bytes spill stores, 76 bytes spill "
        "loads",
        "ptxas info    : Used 179 registers, 432 bytes cmem[0]",
        "ptxas info    : Compiling entry function '%s' for 'sm_90a'" % first,
        "ptxas info    : Function properties for %s" % first,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, 448 bytes cmem[0]"])
    assert tool.parse_ptxas(text) == [
        dict(kernel="pairhmm_wide_kernel<24>", stack=0, spill_stores=0,
             spill_loads=0, registers=126, warps_per_sm=16),
        dict(kernel="pairhmm_reg_kernel<44>", stack=40, spill_stores=116,
             spill_loads=76, registers=179, warps_per_sm=8),
        dict(kernel="pairhmm_kernel", stack=0, spill_stores=0,
             spill_loads=0, registers=40, warps_per_sm=48)]
    assert [tool.warps_per_sm(r) for r in (60, 168, 183, 202, 255)] == \
        [32, 12, 8, 8, 8]
    # the wide instances at their CTAs of G warps: the card's occupancy
    # (tools/pairhmm_bench.py --layouts --widths, ctas_per_sm) at CH 24
    # (126 registers) G 8 and 9, CH 20 (99) G 9, CH 32 (140) G 7
    assert [tool.warps_per_sm(r, g) // g for r, g in (
        (126, 8), (126, 9), (99, 9), (140, 7))] == [2, 1, 1, 1]


def test_bench_tool_backbone_sizes(tmp_path):
    """The bench's inputs: scenario A's 100 backbone sequences (2,400
    pairs with 24 anchors), and dna1k's data at a 1,000-sequence
    backbone (24,000 pairs) from a directory make_scale_dataset.py
    wrote, every sequence full-length (1,271-1,356 residues, under the
    register kernel's widest B)."""
    import subprocess
    import sys
    tool = _bench_tool()
    codes, al = tool.backbone_codes(100)
    assert len(codes) == 100 and al.name == "dna"
    data = tmp_path / "dna1k"
    subprocess.run([sys.executable, tool.os.path.join(
        tool.ROOT, "scripts", "make_scale_dataset.py"), "--n", "1000",
        "--queries", "1000", "--seed", "20260820", "--out", str(data)],
        check=True, capture_output=True, timeout=300)
    codes, _ = tool.backbone_codes(1000, data=str(data))
    lens = [len(c) for c in codes]
    assert len(codes) == 1000 and 1200 < min(lens) <= max(lens) < 1535


def test_bench_tool_long_replays_and_layouts(tmp_path):
    """The bench's replays on the wide layout from the command line:
    --n 120 --queries 30 --cols 1920 --seed 20261018 --backbone 70 is
    scenario A's long input (70 sequences of 1,647-1,686 residues, 1,680
    pairs with 24 anchors) and --data DIR reads a directory
    make_scale_dataset.py wrote; --layouts times the wide candidates
    (--widths needs it), and subsample cuts recorded calls to a seeded
    share of their pairs at the same B width."""
    import subprocess
    import sys
    tool = _bench_tool()
    a = tool.parse_args(["--n", "120", "--queries", "30", "--cols", "1920",
                         "--seed", "20261018", "--backbone", "70",
                         "--layouts"])
    assert (a.n, a.queries, a.cols, a.seed, a.backbone, a.layouts,
            a.data, a.widths) == (120, 30, 1920, 20261018, 70, True, None,
                                  None)
    with pytest.raises(SystemExit):
        tool.parse_args(["--widths", "1536:8192:256"])
    assert tool.parse_args(["--layouts", "--widths", "1536:8192:256"]) \
        .widths == "1536:8192:256"
    codes, al = tool.backbone_codes(70, n=120, queries=30, seed=20261018,
                                    cols=1920)
    lens = [len(c) for c in codes]
    assert len(codes) == 70 and 1535 < min(lens) <= max(lens) < 1700
    data = tmp_path / "long"
    subprocess.run([sys.executable, tool.os.path.join(
        tool.ROOT, "scripts", "make_scale_dataset.py"), "--n", "120",
        "--queries", "30", "--cols", "1920", "--seed", "20261018", "--out",
        str(data)], check=True, capture_output=True, timeout=300)
    a = tool.parse_args(["--data", str(data), "--backbone", "70"])
    again, _ = tool.backbone_codes(a.backbone, data=a.data)
    assert all(np.array_equal(x, y) for x, y in zip(codes, again))
    P, LA, LB = 10, 30, 1700
    args = (torch.zeros((P, LA), dtype=torch.int32),
            torch.arange(1, P + 1, dtype=torch.int32),
            torch.zeros((P, LB), dtype=torch.int32),
            torch.full((P,), LB, dtype=torch.int32),
            torch.ones((4, 4)), 0.02, 0.75)
    sub = tool.subsample([args, args], 6, seed=1)
    assert [len(c[1]) for c in sub] == [3, 3]
    for c in sub:
        assert c[2].shape[1] == LB and c[0].shape[1] == int(c[1].max())
        assert c[4:] == args[4:]
