"""The port's wide layouts (Mp above 4,096 for OA, from 6,432 for flank):
the cluster kernels' layout pickers at every (C, npl) boundary, the
per-CTA table slices (every state in the slot its CTA, warp and lane
read), the launch plan of one pair a cluster, and the slice as a whole:
the JAX pipeline and the port's on the CPU on a backbone of ~4,400
columns, whose every model takes the cluster layouts' widths."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from witch_tpu_torch.device import BankTensors
from witch_tpu_torch.ops._plain import bck_chain, bck_chain_coeffs
from witch_tpu_torch.ops.flank import (FLANK_CLUSTER, FLANK_NPL_C,
                                       FLANK_WARPS, T_DD, T_MD,
                                       flank_layout, flank_slot_index,
                                       flank_tables, smem_bytes)
from witch_tpu_torch.ops.forward import slot_index
from witch_tpu_torch.ops.oa import (OA_CLUSTER, OA_WARPS, oa_layout,
                                    oa_row_bytes, oa_table_index, oa_tables)
from witch_tpu_torch.ops.plan import plan_launches

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SMEM = 232448 - 1024

# (Mp, oa_layout): both sides of every (C, npl) boundary from 4,096 up
OA_WIDE = [(4096, (0, 8, 16, 4096)), (4097, (1, 24, 8, 6144)),
           (4128, (1, 24, 8, 6144)), (6144, (1, 24, 8, 6144)),
           (6145, (1, 32, 8, 8192)), (7072, (1, 32, 8, 8192)),
           (7200, (1, 32, 8, 8192)), (8192, (1, 32, 8, 8192)),
           (8193, (1, 40, 8, 10240)), (10240, (1, 40, 8, 10240)),
           (10241, (1, 48, 8, 12288)), (12288, (1, 48, 8, 12288)),
           (12289, (1, 56, 8, 14336)), (14336, (1, 56, 8, 14336)),
           (14337, (1, 64, 8, 16384)), (16384, (1, 64, 8, 16384)),
           (16385, (1, 40, 16, 20480)), (16416, (1, 40, 16, 20480))]
# (Mp, flank_layout): the last warp-per-pair width and every cluster
# boundary up to the state cap
FLANK_WIDE = [(6304, (0, 5, 40, 6400)), (6432, (1, 16, 16, 8192)),
              (7072, (1, 16, 16, 8192)), (7200, (1, 16, 16, 8192)),
              (8192, (1, 16, 16, 8192)), (8193, (1, 16, 24, 12288)),
              (12288, (1, 16, 24, 12288)), (12289, (1, 24, 24, 18432)),
              (16416, (1, 24, 24, 18432))]


@pytest.mark.parametrize("Mp,want", OA_WIDE)
def test_oa_cluster_layout_boundaries(Mp, want):
    """8 states a lane on the fewest CTAs up to 16,384 states, then 16;
    no CTA of a cluster idle."""
    got = oa_layout(Mp)
    assert got == want
    layout, G, npl, Mpad = got
    if layout == 1:
        C = G // OA_WARPS
        assert G == OA_WARPS * C and 2 <= C <= OA_CLUSTER
        assert Mpad == 32 * G * npl >= Mp
        assert 32 * OA_WARPS * (C - 1) * npl < Mp      # no CTA idle
        if npl == 16:
            assert Mp > 32 * OA_WARPS * OA_CLUSTER * 8


@pytest.mark.parametrize("Mp,want", FLANK_WIDE)
def test_flank_cluster_layout_boundaries(Mp, want):
    """The fewest CTAs, then the fewest states a lane, with each CTA's
    slice of the transitions in its shared memory."""
    got = flank_layout(Mp)
    assert got == want
    layout, G, npl, Mpad = got
    if layout == 1:
        C = G // FLANK_WARPS
        assert 2 <= C <= FLANK_CLUSTER and npl in FLANK_NPL_C
        assert Mpad == 32 * G * npl >= Mp
        assert 32 * FLANK_WARPS * (C - 1) * FLANK_NPL_C[-1] < Mp
        assert smem_bytes(G, Mpad, C) <= SMEM
        # the warp-per-pair kernel could not hold this model's table
        assert smem_bytes(8, 32 * 8 * -(-Mp // 256)) > SMEM or Mp > 6304


def _bank(Mp, H=2, K=5, seed=0):
    rng = np.random.default_rng(seed)
    em = torch.from_numpy(rng.uniform(0.1, 3, (H, K, Mp)).astype(np.float32))
    tr = torch.from_numpy(rng.uniform(0.05, 0.9, (H, 8, Mp))
                          .astype(np.float32))
    return BankTensors(em=em, trans=tr, M=np.full(H, Mp - 8, np.int32),
                       pad_code=K - 1)


@pytest.mark.parametrize("Mp", [4128, 7072, 16416])
def test_oa_cluster_table_slices(Mp):
    """Each CTA c of a pair's cluster copies tr_t[h, c] into its shared
    memory, and its lane (warp w, lane l) reads its j-th state from
    float4 (r npl/4 + j/4) 256 + 32 w + l, component j % 4: that is state
    ((8 c + w) 32 + l) npl + j of the bank, zero beyond Mp. Emissions stay
    in k order."""
    _, G, npl, Mpad = oa_layout(Mp)
    C = G // OA_WARPS
    bt = _bank(Mp, seed=Mp)
    em_t, tr_t = oa_tables(bt, G, npl, C)
    assert oa_tables(bt, G, npl, C)[1] is tr_t        # cached on the bank
    MT = Mpad // C
    assert tr_t.shape == (bt.H, C, 8, MT) and em_t.shape == (bt.H, 5, Mpad)
    assert torch.equal(em_t[..., :Mp], bt.em) and not em_t[..., Mp:].any()
    c, w, lane, j = np.meshgrid(np.arange(C), np.arange(8), np.arange(32),
                                np.arange(npl), indexing="ij")
    k = ((c * 8 + w) * 32 + lane) * npl + j
    at = (((j // 4) * 256 + w * 32 + lane) * 4 + j % 4)
    for r in (0, 3, 6, 7):
        got = tr_t[:, :, r][:, c.ravel(), at.ravel()]
        want = torch.zeros_like(got)
        live = torch.from_numpy((k < Mp).ravel())
        want[:, live] = bt.trans[:, r, torch.from_numpy(k.ravel()[
            k.ravel() < Mp])]
        assert torch.equal(got, want)
    # every state in exactly one slot; C = 1 keeps the warp-per-pair order
    idx = oa_table_index(G, npl, C)
    assert sorted(idx.tolist()) == list(range(Mpad))
    _, G0, n0, M0 = oa_layout(2720)
    h, s, q = np.meshgrid(np.arange(n0 // 4), np.arange(32 * G0),
                          np.arange(4), indexing="ij")
    assert np.array_equal(oa_table_index(G0, n0),
                          (s * n0 + 4 * h + q).reshape(-1))


@pytest.mark.parametrize("Mp", [6432, 8193, 16416])
def test_flank_cluster_table_slices(Mp):
    """Each CTA c holds its 256 lanes' slots in forward's slot layout
    (slot (8 j + w) 32 + l of its slice is state ((8 c + w) 32 + l) npl +
    j), emissions and transitions alike, t_md and t_dd of state Mp - 1
    zeroed; d1_t[h, v] is the Backward chain's unit response at the first
    state of lane v + 1 of the pair (0 past the last lane)."""
    _, G, npl, Mpad = flank_layout(Mp)
    C = G // FLANK_WARPS
    bt = _bank(Mp, seed=Mp + 1)
    em_t, tr_t, d1_t = flank_tables(bt, G, npl, C)
    assert flank_tables(bt, G, npl, C)[2] is d1_t
    MT = Mpad // C
    assert em_t.shape == (bt.H, 5, Mpad) and tr_t.shape == (bt.H, C, 8, MT)
    assert d1_t.shape == (bt.H, 32 * G)
    c, j, w, lane = np.meshgrid(np.arange(C), np.arange(npl), np.arange(8),
                                np.arange(32), indexing="ij")
    k = (((c * 8 + w) * 32 + lane) * npl + j).ravel()
    at = ((j * 8 + w) * 32 + lane).ravel()
    live = k < Mp
    tr = torch.zeros((bt.H, 8, Mpad))
    tr[..., :Mp] = bt.trans
    tr[:, T_MD, Mp - 1] = 0.0
    tr[:, T_DD, Mp - 1] = 0.0
    for r in range(8):
        assert torch.equal(tr_t[:, c.ravel(), r, at], tr[:, r, k])
    got = em_t[:, :, c.ravel() * MT + at]
    assert torch.equal(got[..., live], bt.em[:, :, k[live]])
    assert not got[..., ~live].any()
    t = tr[:, T_DD].double()
    d1 = bck_chain(torch.ones_like(t), bck_chain_coeffs(t)).float()
    v = np.arange(32 * G)
    nxt = (v + 1) * npl
    ok = nxt < Mpad
    assert torch.equal(d1_t[:, ok], d1[:, nxt[ok]])
    assert not d1_t[:, ~ok].any()
    # C = 1 is forward's slot layout
    assert np.array_equal(flank_slot_index(Mp, 5, 40), slot_index(Mp, 5, 40))


@pytest.mark.parametrize("seed,n,n_models,Mp,budget_pairs", [
    (1, 1, 1, 7072, 1), (2, 120, 10, 7072, 7), (3, 300, 53, 7200, 40),
    (4, 64, 3, 16416, 10 ** 6)])
def test_cluster_plan_every_pair_once(seed, n, n_models, Mp, budget_pairs):
    """One pair a cluster (wp 1): every pair once, longest first, each
    launch's rows within its budget (a launch of one pair may exceed
    it), and the pairs' rows side by side in their launch."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1000, 4300, n)
    models = rng.integers(0, n_models, n)
    _, _, _, Mpad = oa_layout(Mp)
    row_bytes = oa_row_bytes(Mpad)
    budget = budget_pairs * 2700 * row_bytes
    plan = plan_launches(lens, models, 1, row_bytes, budget)
    assert sorted(plan.cta_env.tolist()) == list(range(n))   # no empty slot
    assert np.all(np.diff(lens[plan.cta_env]) <= 0)
    for t, (a, b) in enumerate(zip(plan.cta0[:-1], plan.cta0[1:])):
        pairs = plan.cta_env[a:b]
        assert plan.n_rows[t] == int(lens[pairs].sum())
        if b - a > 1:
            assert plan.n_rows[t] * row_bytes <= budget
        spans = sorted((int(plan.roff[e]), int(plan.roff[e] + lens[e]))
                       for e in pairs)
        assert spans[0][0] == 0 and spans[-1][1] == plan.n_rows[t]
        for (_, end), (start, _) in zip(spans[:-1], spans[1:]):
            assert end == start
    if budget_pairs == 1:
        assert plan.launches == n


def _wide_data(tmp_path, cut=300):
    """make_scale_dataset.py at 16 sequences of ~4,400 columns and 4
    queries, each cut to its first `cut` residues."""
    out = tmp_path / "data"
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_scale_dataset.py"),
                    "--n", "16", "--queries", "4", "--cols", "5000",
                    "--seed", "20261017", "--out", str(out)], check=True,
                   capture_output=True, timeout=120)
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta
    q = [(n, s[:cut]) for n, s in read_fasta(str(out / "queries.fasta"))]
    write_fasta(q, str(out / "q300.fasta"))
    return ["-b", str(out / "backbone.aln.fasta.gz"),
            "-e", str(out / "backbone.tre"),
            "-q", str(out / "q300.fasta"), "-o", "aligned.fasta"]


def test_wide_slice_matches_jax(tmp_path, monkeypatch):
    """Scenario D on a ~4,400-column DNA backbone, every alignment bank
    above Mp 4,096 (the OA cluster layout's widths; at these widths the
    flank kernel is still warp-per-pair): the port on the CPU (plain
    versions) and the JAX package give the same masked rows."""
    from witch_tpu.cli import init_parser as jax_parser
    from witch_tpu.config import build_configs as jax_configs
    from witch_tpu.io.fasta import read_fasta
    from witch_tpu.pipeline import main_alignment_process as jax_main
    from witch_tpu_torch import _build
    import witch_tpu_torch.aligner as AL
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    args = _wide_data(tmp_path)
    jax_configs(jax_parser(), args + ["-d", str(tmp_path / "jax")])
    jax_main()
    widths = []
    to_torch = AL.bank_to_torch

    def seen(bank, device):
        bt = to_torch(bank, device)
        widths.append(bt.Mp)
        return bt
    monkeypatch.setattr(AL, "bank_to_torch", seen)
    build_configs(init_parser(), args + ["-d", str(tmp_path / "port")])
    _build.reset_launches()
    main_alignment_process(device="cpu")
    assert not any(_build.LAUNCHES.values())          # plain versions only
    assert widths and all(oa_layout(m)[0] == 1 for m in widths)
    f = "aligned.masked.fasta"
    mine = dict(read_fasta(str(tmp_path / "port" / f)))
    ref = dict(read_fasta(str(tmp_path / "jax" / f)))
    assert len(ref) == 20 and mine == ref


def _wide_case(M, n, seed):
    """One DNA model of M states and n query fragments of its consensus
    (80 to 400 residues, 5% mutated), as a bank of the card."""
    from witch_tpu.core.alphabet import DNA
    from witch_tpu.hmm.bank import build_banks
    from witch_tpu.hmm.build import build_hmm
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, M)
    rows = np.array([np.where(rng.random(M) < 0.1, rng.integers(0, 4, M),
                              base) for _ in range(5)], np.uint8)
    bank = build_banks([build_hmm(rows, DNA, "dna")], uniform=True)[0]
    qs = []
    for _ in range(n):
        L = int(rng.integers(80, 400))
        a = int(rng.integers(0, M - L))
        q = base[a:a + L].copy()
        mut = rng.random(L) < 0.05
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        qs.append(q.astype(np.int32))
    return bank, qs


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4100, 7000, 12300])
def test_oa_cluster_kernel_matches_plain_and_first(M):
    """The OA cluster instance (C 3, 4 and 7 CTAs of 8 states a lane)
    against the plain version and the first version: the same flags,
    columns above the 2e-3 guard, finite margins within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch import _build
    from witch_tpu_torch.device import bank_to_torch
    from witch_tpu_torch.ops.oa import oa_nats, oa_ref, pack_pairs
    bank, qs = _wide_case(M, 10, M)
    bt = bank_to_torch(bank, "cuda")
    assert oa_layout(bt.Mp)[0] == 1
    pk = pack_pairs(bt, [(0, q) for q in qs])
    _build.reset_launches()
    ck, sk = oa_nats(bt, *pk)
    assert _build.LAUNCHES["oa"] == 1
    cf, sf = oa_nats(bt, *pk, Ldmax=400, first_version=True)
    cp, sp = oa_ref(bt, *pk)
    off = pk[3].cpu().numpy()
    ck, sk, cf, sf, cp, sp = (x.cpu().numpy()
                              for x in (ck, sk, cf, sf, cp, sp))
    for other_c, other_s in ((cp, sp), (cf, sf)):
        np.testing.assert_array_equal(sk[:, 1], other_s[:, 1])
        fin = np.isfinite(sk[:, 0])
        np.testing.assert_array_equal(fin, np.isfinite(other_s[:, 0]))
        assert np.abs(sk[fin, 0] - other_s[fin, 0]).max(initial=0) < 1e-4
        for t, q in enumerate(qs):
            if sk[t, 0] >= 2e-3:
                a = slice(off[t], off[t] + len(q))
                np.testing.assert_array_equal(ck[a], other_c[a])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [6400, 9000, 12300])
def test_flank_cluster_kernel_matches_plain_and_first(M):
    """The flank cluster instance (C 2 at 16 and 24 states a lane, Mp
    6,432 and 9,120; C 3 at 24, Mp 12,320) against the plain version
    within 5e-3 nats (fwd) and 2e-3 (rows), the JAX package's own
    bounds, and the first version within the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch import _build
    from witch_tpu_torch.device import bank_to_torch
    from witch_tpu_torch.ops.flank import flank_rows, flank_rows_ref
    bank, qs = _wide_case(M, 9, M + 1)
    bt = bank_to_torch(bank, "cuda")
    assert flank_layout(bt.Mp)[0] == 1
    codes = np.zeros((len(qs), max(map(len, qs))), np.int32)
    for i, q in enumerate(qs):
        codes[i, :len(q)] = q
    c = torch.from_numpy(codes).cuda()
    ln = torch.from_numpy(np.array([len(q) for q in qs], np.int32)).cuda()
    _build.reset_launches()
    got = flank_rows(bt, c, ln)
    assert _build.LAUNCHES["flank"] == 1
    ref = flank_rows_ref(bt, c, ln)
    first = flank_rows(bt, c, ln, first_version=True)
    for other in (ref, first):
        assert float((got[0] - other[0]).abs().max()) <= 5e-3
        for a, b in zip(got[1:], other[1:]):
            assert float((a - b).abs().max()) <= 2e-3
