"""Port's flank posterior rows (plain version on the CPU) vs the JAX
device scans (witch_tpu/hmm/flank_device.py:flank_rows_bank), and the
whole --full-search-results path (device flank prefilter + native
domain definition) vs the JAX pipeline, on seeded inputs."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from witch_tpu.cli import init_parser
from witch_tpu.config import build_configs
from witch_tpu.io.fasta import read_fasta, write_fasta
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.hmm.flank_device import (RT1, RT2, RT3,
                                              gate_prefilter)
from witch_tpu_torch.ops.flank import flank_rows, flank_rows_ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _toy():
    """The toy bank of tests/test_flank_device.py (ragged lengths)."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bank, qcodes, qlens, _, cores = mod._toy_bank_and_queries(
        H=3, M=24, Q=6, L=40, seed=3)
    qlens = qlens.copy()
    qlens[1] = 23
    qlens[4] = 31
    for q, L in enumerate(qlens):
        qcodes[q, L:] = 0
    return bank, qcodes.astype(np.int32), qlens.astype(np.int32), cores


def _port_rows(bank, qcodes, qlens, device="cpu"):
    out = flank_rows(bank_to_torch(bank, device), torch.from_numpy(
        qcodes).to(device), torch.from_numpy(qlens).to(device))
    return [x.cpu().numpy() for x in out]


def test_flank_rows_match_jax():
    """Rows within 2e-3 and fwd within 5e-3 nats (the JAX package's own
    bounds against f64, tests/test_flank_device.py:56-62); measured on
    this bank: 4.8e-7 nats fwd, 9e-7 rows."""
    from witch_tpu.hmm.flank_device import flank_rows_bank
    from witch_tpu.hmm.flank_device import gate_prefilter as gate_jax
    bank, qcodes, qlens, _ = _toy()
    ref = [np.asarray(x) for x in flank_rows_bank(
        bank.em_odds, bank.t_mm, bank.t_mi, bank.t_md, bank.t_im,
        bank.t_ii, bank.t_dm, bank.t_dd, bank.bm, qcodes, qlens)]
    got = _port_rows(bank, qcodes, qlens)
    assert abs(got[0] - ref[0]).max() < 5e-3
    for g, r in zip(got[1:], ref[1:]):
        assert g.shape == r.shape
        assert abs(g - r).max() < 2e-3
    for q, L in enumerate(qlens):          # padded tail zeroed
        assert not got[1][q, :, L + 1:].any()
        assert not got[3][q, :, L + 1:].any()
    Q, H = qcodes.shape[0], bank.H
    flat = lambda a: a.reshape(Q * H, -1)   # noqa: E731
    d_got, p_got = gate_prefilter(flat(got[3]), flat(got[1]),
                                  flat(got[2]), np.repeat(qlens, H))
    d_ref, p_ref = gate_jax(flat(ref[3]), flat(ref[1]), flat(ref[2]),
                            np.repeat(qlens, H))
    np.testing.assert_array_equal(d_got, d_ref)
    assert p_got == p_ref


def test_gate_prefilter_copy_matches_jax():
    """The copied region scan and three-way decision equal the JAX
    module's on synthetic rows that exercise every branch."""
    from witch_tpu.hmm import flank_device as jfd
    assert (RT1, RT2, RT3) == (jfd.RT1, jfd.RT2, jfd.RT3)
    rng = np.random.default_rng(4)
    N, Lp1 = 64, 50
    mocc = np.clip(rng.random((N, Lp1)) * rng.random((N, 1)) * 1.2, 0, 1)
    ppB = (rng.random((N, Lp1)) * 0.3).astype(np.float32)
    ppE = (rng.random((N, Lp1)) * 0.3).astype(np.float32)
    mocc = mocc.astype(np.float32)
    qlens = rng.integers(10, Lp1, N)
    d, p = gate_prefilter(mocc, ppB, ppE, qlens)
    dj, pj = jfd.gate_prefilter(mocc, ppB, ppE, qlens)
    np.testing.assert_array_equal(d, dj)
    assert p == pj
    assert set(d.tolist()) == {-1, 0, 1}


def test_flank_wrapper_on_cpu_is_the_plain_version():
    bank, qcodes, qlens, _ = _toy()
    bt = bank_to_torch(bank, "cpu")
    c, ln = torch.from_numpy(qcodes), torch.from_numpy(qlens)
    for a, b in zip(flank_rows(bt, c, ln), flank_rows_ref(bt, c, ln)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _grid_problem():
    """Protein models with homologous fragments and random junk queries:
    (banks, codes, lens, col_of)."""
    from witch_tpu.core.alphabet import ALPHABETS
    from witch_tpu.hmm.bank import build_banks
    from witch_tpu.hmm.build import build_hmm
    amino = ALPHABETS["amino"]
    rng = np.random.default_rng(12)
    cores, queries = [], []
    for M in (40, 70, 110):
        base = rng.integers(0, 20, M)
        rows = np.array([np.where(rng.random(M) < 0.15,
                                  rng.integers(0, 20, M), base)
                         for _ in range(8)], np.uint8)
        cores.append(build_hmm(rows, amino, "amino"))
        a = int(rng.integers(0, M - 30))
        queries.append(base[a:a + 30])
    queries += [rng.integers(0, 20, int(n)) for n in (35, 50, 64)]
    lens = np.array([len(q) for q in queries], np.int32)
    codes = np.zeros((len(queries), lens.max()), np.int32)
    for i, q in enumerate(queries):
        codes[i, :len(q)] = q
    banks = build_banks(cores, indices=[0, 1, 2], uniform=True,
                        n_buckets=2)
    return banks, codes, lens, {0: 0, 1: 1, 2: 2}


def _port_grid(banks, codes, lens, col_of):
    from witch_tpu_torch.hmm.flank_device import prefilter_grid
    return prefilter_grid(
        [bank_to_torch(b, "cpu") for b in banks],
        [[col_of[int(i)] for i in b.hmm_indices] for b in banks],
        codes, lens, len(col_of))


def test_prefilter_grid_matches_jax():
    """The port's full-grid prefilter vs the JAX one: identical
    decisions (some pairs dropped), and the rows handed to the native
    engine within 2e-3 of the JAX rows."""
    from witch_tpu.hmm.flank_device import prefilter_grid as jax_grid
    banks, codes, lens, col_of = _grid_problem()
    dj, rows_j = jax_grid(banks, codes, lens, col_of, 3, return_rows=True)
    dec, rows = _port_grid(banks, codes, lens, col_of)
    np.testing.assert_array_equal(dec, dj)
    assert (dec < 0).any() and (dec >= 0).any()
    for j in range(3):
        qs = np.flatnonzero(dec[:, j] >= 0)
        if not qs.size:
            assert j not in rows
            continue
        np.testing.assert_array_equal(rows[j][0], qs)
        for got, ref in zip(rows[j][1:], rows_j):
            assert got.dtype == np.float32 and got.flags.c_contiguous
            assert abs(got - ref[qs, j]).max() < 2e-3


def test_prefilter_grid_query_chunks_agree(monkeypatch):
    """One query per chunk (the bound on device memory at its smallest)
    gives the decisions and kept rows of a single chunk."""
    from witch_tpu_torch.hmm import flank_device
    banks, codes, lens, col_of = _grid_problem()
    dec, rows = _port_grid(banks, codes, lens, col_of)
    monkeypatch.setattr(flank_device, "CHUNK_BYTES", 1)
    dec1, rows1 = _port_grid(banks, codes, lens, col_of)
    np.testing.assert_array_equal(dec1, dec)
    assert rows1.keys() == rows.keys() and rows
    for j in rows:
        for a, b in zip(rows1[j], rows[j]):
            assert a.dtype == b.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)


@pytest.fixture()
def tiny_problem(tmp_path):
    """The seeded problem of tests/test_device_gate_prefilter.py:20-44."""
    rng = np.random.default_rng(23)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 120)]
    rows = []
    for i in range(24):
        s = base.copy()
        mut = rng.random(120) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        gap = rng.random(120) < 0.05
        s = np.where(gap, "-", s)
        rows.append((f"t{i}", "".join(s)))
    bb_path = tmp_path / "bb.fasta"
    write_fasta(rows, str(bb_path))
    queries = []
    for i in range(6):
        src = rows[rng.integers(0, 24)][1].replace("-", "")
        a = rng.integers(0, 30)
        queries.append((f"q{i}", src[a:a + 55]))
    queries.append(("junk", "".join(letters[rng.integers(0, 4, 50)])))
    q_path = tmp_path / "q.fasta"
    write_fasta(queries, str(q_path))
    return bb_path, q_path


def _read_results(outdir):
    res = {}
    droot = os.path.join(str(outdir), "tree_decomp", "root")
    for d in sorted(os.listdir(droot)):
        f = os.path.join(droot, d, "hmmsearch.results.%s.fragment_chunk_0"
                         % d)
        if os.path.exists(f):
            with open(f) as fh:
                res[d] = eval(fh.read())  # reference literal-dict format
    return res


def test_full_search_matches_jax(tiny_problem, tmp_path):
    """Persisted pair sets identical, scores within 0.05 bits, masked
    rows equal; the port's run went through the flank prefilter."""
    from witch_tpu.pipeline import main_alignment_process as jax_main
    from witch_tpu_torch import _build
    from witch_tpu_torch.cli import init_parser as port_parser
    from witch_tpu_torch.config import build_configs as port_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    bb, q = tiny_problem
    args = ["-q", str(q), "-b", str(bb), "-o", "aligned.fasta",
            "--full-search-results", "1", "--keep-decomposition", "1"]
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    build_configs(init_parser(), args + ["-d", str(out_j)])
    jax_main()
    port_configs(port_parser(), args + ["-d", str(out_p)])
    _build.reset_launches()
    main_alignment_process(device="cpu")
    assert not any(_build.LAUNCHES.values())      # plain versions only
    rj, rp = _read_results(out_j), _read_results(out_p)
    assert rj.keys() == rp.keys() and rj
    for d in rj:
        assert set(rj[d]) == set(rp[d]), d
        for taxon, (_, sc) in rj[d].items():
            assert rp[d][taxon][1] == pytest.approx(sc, abs=0.05), (d, taxon)
    a_j = dict(read_fasta(str(out_j / "aligned.masked.fasta")))
    a_p = dict(read_fasta(str(out_p / "aligned.masked.fasta")))
    assert a_j == a_p
    with open(out_p / "runtime_breakdown.txt") as fh:
        assert "device gate prefilter" in fh.read()


@pytest.mark.cuda
def test_flank_kernel_on_card_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu_torch import _build
    bank, qcodes, qlens, _ = _toy()
    _build.reset_launches()
    got = _port_rows(bank, qcodes, qlens, "cuda")
    assert _build.LAUNCHES["flank"] == 1
    bt = bank_to_torch(bank, "cuda")
    ref = [x.cpu().numpy() for x in flank_rows_ref(
        bt, torch.from_numpy(qcodes).cuda(), torch.from_numpy(qlens).cuda())]
    assert abs(got[0] - ref[0]).max() < 5e-3
    for g, r in zip(got[1:], ref[1:]):
        assert abs(g - r).max() < 2e-3


@pytest.mark.cuda
def test_forward_and_flank_kernels_at_the_state_cap():
    """A 16,384-state model (Mp 16,416): the forward kernel's second
    layout keeps three f32 rows in shared memory (197 KB of the 227 KB);
    the flank kernel's cluster instance (ops/flank.py:flank_layout 1,
    above the warp-per-pair kernel's widths) spreads the pair over 3
    CTAs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from witch_tpu.core.alphabet import DNA
    from witch_tpu.hmm.bank import build_banks
    from witch_tpu.hmm.build import build_hmm
    from witch_tpu_torch.ops.forward import LN2, forward_nats, \
        forward_nats_ref
    M = 16384
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, M)
    rows = np.array([np.where(rng.random(M) < 0.1, rng.integers(0, 4, M),
                              base) for _ in range(4)], np.uint8)
    bank = build_banks([build_hmm(rows, DNA, "dna")], uniform=True)[0]
    bt = bank_to_torch(bank, "cuda")
    assert bt.Mp == 16416
    lens = rng.integers(60, 160, 5).astype(np.int32)
    codes = np.zeros((5, lens.max()), np.int32)
    for i, L in enumerate(lens):
        a = int(rng.integers(0, M - L))
        codes[i, :L] = base[a:a + L]
    c, ln = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
    d = (forward_nats(bt, c, ln) - forward_nats_ref(bt, c, ln)).abs() / LN2
    assert float(d.max()) < 1e-3
    from witch_tpu_torch.ops.flank import flank_layout
    assert flank_layout(bt.Mp)[0] == 1
    k, p = flank_rows(bt, c, ln), flank_rows_ref(bt, c, ln)
    assert float((k[0] - p[0]).abs().max()) < 5e-3
    for a, b in zip(k[1:], p[1:]):
        assert float((a - b).abs().max()) < 2e-3
