"""The port's data mesh (witch_tpu_torch/parallel/mesh.py) on the CPU,
the counterparts of tests/test_parallel.py:23-155: scoring over eight CPU
entries (mesh.visible_cards replaced, as the JAX package's tests score on
eight virtual CPU devices) is bit-identical to the single path and within
the forward parity bar of the JAX package's sharded scoring; the
pipeline writes the same files with and without the mesh, and the JAX
package's rows; a sharded run, a card index or WITCH_TPU_NO_MESH forms
no mesh; "cuda" and the current card's "cuda:i" are one bank cache entry.
The tests marked cuda run on the card (python -m pytest -m cuda
tests/test_torch_mesh.py); JAX is imported inside the CPU tests only."""

import os
import threading

import numpy as np
import pytest
import torch

from witch_tpu_torch import device as D
from witch_tpu_torch.parallel import mesh as M

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")
FWD_BAR = 1e-3          # forward parity bar in bits (ROADMAP.md)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture
def cpu_mesh(monkeypatch):
    """Eight CPU entries as the visible cards."""
    monkeypatch.setattr(M, "visible_cards", lambda: list(CPU8))
    monkeypatch.delenv("WITCH_TPU_NO_MESH", raising=False)
    monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)


def _toy_bank(H=8, Q=19):
    """tests/test_parallel.py's toy: __graft_entry__'s bank and queries."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bank, qcodes, qlens, _, _ = mod._toy_bank_and_queries(H=H, Q=Q)
    return bank, qcodes, qlens


def _ragged_bank(seed):
    """The widest bank of three seeded models (witch_tpu's build_banks,
    two width buckets) and 23 queries of 15-119 residues."""
    from test_torch_forward import grid
    _, banks, _, codes, lens = grid(seed, n_q=23)
    return banks[-1], codes, lens


def test_mesh_helpers(cpu_mesh):
    """data_mesh of eight entries, none of one; make_mesh's (data, model)
    factoring, against witch_tpu.parallel.dist.make_mesh's on its eight
    virtual CPU devices."""
    import jax
    from witch_tpu.parallel.dist import make_mesh as jax_make_mesh
    assert M.data_mesh(8) == CPU8
    assert M.data_mesh(1) is None
    assert M.make_mesh(8, model_parallel=4).shape == (2, 4)
    if len(jax.devices()) >= 8:
        assert M.make_mesh(8).shape == tuple(jax_make_mesh(8).shape.values())
    with pytest.raises(ValueError):
        M.make_mesh(8, model_parallel=3)


def test_no_cards_no_mesh():
    """Without CUDA (this host) there is no mesh to form."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert M.visible_cards() == []
    assert M.data_mesh() is None
    assert M.scoring_mesh(None, 1) is None


CARDS4 = [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("device, env, n_shards, cards, formed", [
    (None, "", 1, CARDS4, True),
    ("cuda", "", 1, CARDS4, True),
    (torch.device("cuda"), "", 1, CARDS4, True),
    ("cuda:0", "", 1, CARDS4, False),       # the caller named a card
    ("cuda:2", "", 1, CARDS4, False),
    ("cpu", "", 1, CARDS4, False),
    (None, "1", 1, CARDS4, False),          # WITCH_TPU_NO_MESH
    (None, "", 2, CARDS4, False),           # a shard keeps its card
    (None, "", 1, CARDS4[:1], False),       # one card
])
def test_scoring_mesh_forms_when(device, env, n_shards, cards, formed,
                                 monkeypatch):
    monkeypatch.setattr(M, "visible_cards", lambda: list(cards))
    monkeypatch.setenv("WITCH_TPU_NO_MESH", env)
    got = M.scoring_mesh(device, n_shards)
    assert got == (cards if formed else None)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 30])
def test_deal_covers_each_query_once_near_equal_residues(n):
    """Every query on exactly one card, and each card's residues within
    one query's length of every other's."""
    rng = np.random.default_rng(n)
    lens = rng.integers(1, 400, 29)
    parts = M.deal(lens, n)
    assert len(parts) == n
    assert sorted(np.concatenate(parts).tolist()) == list(range(29))
    res = [int(lens[p].sum()) for p in parts]
    assert max(res) - min(res) <= lens.max()
    assert all(np.all(np.diff(p) > 0) for p in parts)


@pytest.mark.parametrize("data", ["toy", "ragged_5", "ragged_31"])
def test_sharded_scoring_bit_identical(data, cpu_mesh):
    """The port's scores on the eight-entry mesh are np.array_equal to its
    single-path scores, and both lie within FWD_BAR bits of
    witch_tpu.parallel.dist.sharded_score_bank on its eight virtual CPU
    devices (XLA scans) on the same bank and queries (the toy's Q = 19 is
    ragged over 8 entries, as in the JAX package's test)."""
    import jax
    from witch_tpu.parallel.dist import data_mesh, sharded_score_bank
    from witch_tpu_torch.ops.forward import forward_bits
    if data == "toy":
        bank, codes, lens = _toy_bank()
    else:
        bank, codes, lens = _ragged_bank(int(data.split("_")[1]))
    bt = D.bank_to_torch(bank, "cpu")
    single = forward_bits(bt, codes, lens)
    cards = M.data_mesh()
    sharded, ms = M.sharded_forward_bits(
        [D.bank_to_torch(bank, d) for d in cards], codes, lens)
    assert len(ms) == 8
    assert np.array_equal(sharded, single)
    if len(jax.devices()) < 8:
        pytest.skip("needs the JAX package's 8-device virtual mesh")
    ref = sharded_score_bank(data_mesh(8), bank, codes.astype(np.int32),
                             lens.astype(np.int32), backend="xla")
    np.testing.assert_allclose(sharded, ref, atol=FWD_BAR, rtol=0)


def test_a_failed_card_raises_and_moves_nothing(cpu_mesh, monkeypatch):
    """No fallback: a card whose launch fails raises out of the mesh."""
    from witch_tpu_torch.ops import forward as F
    bank, codes, lens = _toy_bank()
    bts = [D.bank_to_torch(bank, d) for d in M.data_mesh()]
    calls = []
    real = F.forward_nats

    def failing(bt, c, l, events=None):
        calls.append(len(l))
        if len(calls) == 3:
            raise RuntimeError("CUDA kernel forward failed to launch")
        return real(bt, c, l, events)

    monkeypatch.setattr(F, "forward_nats", failing)
    with pytest.raises(RuntimeError, match="failed to launch"):
        M.sharded_forward_bits(bts, codes, lens)
    assert len(calls) == 3


def _seed7_data(d):
    """The seeded DNA data of tests/test_parallel.py:
    test_pipeline_identical_outputs_with_mesh (24 x 100 backbone, 7
    queries, no tree)."""
    from witch_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(7)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 100)]
    rows = []
    for i in range(24):
        s = base.copy()
        mut = rng.random(100) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        rows.append((f"t{i}", "".join(s)))
    queries = []
    for i in range(7):
        src = rows[rng.integers(0, 24)][1]
        a = rng.integers(0, 30)
        queries.append((f"q{i}", src[a:a + 50]))
    write_fasta(rows, str(d / "bb.fasta"))
    write_fasta(queries, str(d / "q.fasta"))
    return ["-b", str(d / "bb.fasta"), "-q", str(d / "q.fasta"),
            "-o", "aligned.fasta", "--save-weight", "1"]


def _port(args, outdir, device="cpu"):
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import Configs, build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    build_configs(init_parser(), args + ["-d", str(outdir)])
    out = main_alignment_process(device=device)
    return out, list(Configs.scoring_cards)


def _lines(path, what):
    with open(path) as f:
        return [ln for ln in f if what in ln]


def test_pipeline_identical_outputs_with_mesh(tmp_path, cpu_mesh,
                                              monkeypatch):
    """End to end on the seed-7 data with --save-weight 1: the port on the
    eight-entry mesh writes the aligned.fasta and weights.txt of its run
    with WITCH_TPU_NO_MESH=1, byte for byte, its log says so, and its rows
    equal the JAX package's run of the same flags (on its eight-device
    mesh)."""
    import jax
    from witch_tpu.cli import init_parser as jax_parser
    from witch_tpu.config import build_configs as jax_configs
    from witch_tpu.io.fasta import read_fasta
    from witch_tpu.pipeline import main_alignment_process as jax_main
    args = _seed7_data(tmp_path)
    out, cards = _port(args, tmp_path / "mesh")
    assert cards == ["cpu"] * 8
    assert _lines(tmp_path / "mesh" / "log.txt",
                  "Scoring on 8-device data mesh")
    fwd = _lines(tmp_path / "mesh" / "runtime_breakdown.txt",
                 "scoring: device Forward")
    assert fwd and all("on 8 cards (kernel ms cpu " in ln for ln in fwd)
    monkeypatch.setenv("WITCH_TPU_NO_MESH", "1")
    _, cards1 = _port(args, tmp_path / "single")
    assert cards1 == ["cpu"]
    assert not _lines(tmp_path / "single" / "log.txt", "data mesh")
    for f in ("aligned.fasta", "aligned.masked.fasta", "weights.txt"):
        assert (tmp_path / "mesh" / f).read_bytes() == \
            (tmp_path / "single" / f).read_bytes(), f
    monkeypatch.delenv("WITCH_TPU_NO_MESH")
    assert len(jax.devices()) >= 8, "the JAX package's run needs its mesh"
    jax_configs(jax_parser(), args + ["-d", str(tmp_path / "jax")])
    jax_out = jax_main()
    assert dict(read_fasta(out)) == dict(read_fasta(jax_out))
    assert (tmp_path / "jax" / "weights.txt").exists()


def _mode_args(mode, d):
    """Flags of one scoring mode on small seeded data (no JAX needed)."""
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta
    if mode == "D":         # the amino golden's backbone and tree
        write_fasta(list(read_fasta(os.path.join(
            GOLD, "ref_amino.queries.fasta")))[:12], str(d / "q.fasta"))
        return ["-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
                "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
                "-q", str(d / "q.fasta"), "-o", "aligned.fasta",
                "--molecule", "amino"]
    if mode == "A":         # 24 full-length rows of 100 and 6 fragments
        rng = np.random.default_rng(5)
        letters = np.array(list("ACGT"))
        base = letters[rng.integers(0, 4, 100)]
        records = []
        for i in range(24):
            s = base.copy()
            mut = rng.random(100) < 0.08
            s[mut] = letters[rng.integers(0, 4, mut.sum())]
            records.append((f"f{i}", "".join(s)))
        for i in range(6):
            a = rng.integers(0, 40)
            records.append((f"q{i}", records[i][1][a:a + 45]))
        write_fasta(records, str(d / "all.fasta"))
        return ["-i", str(d / "all.fasta"), "-o", "aligned.fasta"]
    extra = {"full_search": ["--full-search-results", "1"],
             "old_witch": ["-m", "old-witch"]}[mode]
    return _seed7_data(d)[:-2] + extra


@pytest.mark.parametrize("mode", ["D", "A", "full_search", "old_witch"])
def test_modes_identical_with_mesh(mode, tmp_path, cpu_mesh, monkeypatch):
    """Scenario D (the amino golden's first 12 queries), scenario A,
    --full-search-results and -m old-witch (scenario C, the seed-7 data,
    is test_pipeline_identical_outputs_with_mesh): on the eight-entry
    mesh the same output files, and persisted search results, as with
    WITCH_TPU_NO_MESH=1."""
    import glob
    args = _mode_args(mode, tmp_path)
    _, cards = _port(args, tmp_path / "mesh")
    assert cards == ["cpu"] * 8
    assert _lines(tmp_path / "mesh" / "log.txt",
                  "Scoring on 8-device data mesh")
    monkeypatch.setenv("WITCH_TPU_NO_MESH", "1")
    _port(args, tmp_path / "single")
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert (tmp_path / "mesh" / f).read_bytes() == \
            (tmp_path / "single" / f).read_bytes(), f

    def results(tag):
        root = str(tmp_path / tag)
        return {os.path.relpath(p, root): open(p, "rb").read()
                for p in glob.glob(os.path.join(
                    root, "**", "hmmsearch.results.*"), recursive=True)}
    assert results("mesh") == results("single")
    if mode == "full_search":
        assert results("mesh")


def test_sharded_run_forms_no_mesh(tmp_path, cpu_mesh, monkeypatch):
    """WITCH_TPU_SHARD=0/2 with eight entries visible: no mesh, scoring
    on the one device; the pair of shards merges to the unsharded run's
    bytes."""
    args = _seed7_data(tmp_path)[:-2]      # sharded: no weights.txt
    _port(args, tmp_path / "single")
    monkeypatch.setenv("WITCH_TPU_SHARD", "0/2")
    out, cards = _port(args, tmp_path / "sharded")
    assert out is None and cards == ["cpu"]
    assert not _lines(tmp_path / "sharded" / "log.txt", "data mesh")
    fwd = _lines(tmp_path / "sharded" / "runtime_breakdown.txt",
                 "scoring: device Forward")
    assert fwd and not any(" cards " in ln for ln in fwd)
    monkeypatch.setenv("WITCH_TPU_SHARD", "1/2")
    out, cards = _port(args, tmp_path / "sharded")
    assert out is not None and cards == ["cpu"]
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert (tmp_path / "sharded" / f).read_bytes() == \
            (tmp_path / "single" / f).read_bytes(), f


def test_server_job_records_its_cards(tmp_path, cpu_mesh, monkeypatch):
    """serve(device="cpu") in this process with eight entries visible: its
    server.alive and the job's .done list the eight cards beside the
    device, and the job's outputs are an in-process run's."""
    import json
    from witch_tpu_torch import server
    monkeypatch.setenv("WITCH_TPU_IN_SERVER", "")
    jobs = str(tmp_path / "jobs")
    args = _seed7_data(tmp_path)
    alive = []
    write_alive = server._write_alive

    def record(path, device, cards=None):
        alive.append((str(device), cards))
        write_alive(path, device, cards)

    monkeypatch.setattr(server, "_write_alive", record)
    os.makedirs(jobs)
    with open(os.path.join(jobs, "a.job"), "w") as f:
        json.dump({"argv": args + ["-d", str(tmp_path / "served")]}, f)
    t = threading.Thread(target=server.serve, args=(jobs,),
                         kwargs=dict(poll_s=0.05, max_idle_s=1.0,
                                     device="cpu"), daemon=True)
    t.start()
    t.join(timeout=600)
    assert not t.is_alive()
    with open(os.path.join(jobs, "a.done")) as f:
        done = json.load(f)
    assert done["ok"], done["error"]
    assert done["device"] == "cpu" and done["cards"] == ["cpu"] * 8
    assert alive == [("cpu", ["cpu"] * 8)]
    monkeypatch.setenv("WITCH_TPU_NO_MESH", "1")
    _port(args, tmp_path / "single")
    for f in ("aligned.fasta", "weights.txt"):
        assert (tmp_path / "served" / f).read_bytes() == \
            (tmp_path / "single" / f).read_bytes(), f


def test_cuda_and_current_card_share_a_cache_entry(monkeypatch):
    """canonical_device names "cuda" by the current card, so "cuda" and
    that card's "cuda:i" key one bank cache entry, and another card's
    does not (checked here through the key, with the current card
    stubbed; on the card by test_cache_entry_on_card)."""
    bank, _, _ = _toy_bank(H=2, Q=1)
    for cur in (0, 1):
        monkeypatch.setattr(torch.cuda, "current_device", lambda: cur)
        assert D.canonical_device("cuda") == torch.device("cuda", cur)
        assert D.canonical_device(torch.device("cuda")) == \
            torch.device("cuda", cur)
        assert D._bank_key(bank, "cuda") == D._bank_key(bank, "cuda:%d" % cur)
        assert D._bank_key(bank, "cuda") != \
            D._bank_key(bank, "cuda:%d" % (1 - cur))
    assert D.canonical_device("cuda:3") == torch.device("cuda", 3)
    assert D.canonical_device("cpu") == torch.device("cpu")
    assert D.resolve_device("cpu") == torch.device("cpu")


def test_cache_holds_a_mesh_jobs_banks(monkeypatch):
    """cache_banks sizes the bound to twice a job's banks x cards: ten
    banks stay resident where the old bound of 8 evicted the first two;
    the bound never shrinks."""
    monkeypatch.setattr(D, "_CACHE", {})
    monkeypatch.setattr(D, "_cache_max", D._CACHE_MIN)
    from test_torch_forward import synth_core
    from witch_tpu.hmm.bank import build_banks
    banks = [build_banks([synth_core(20 + k, 4, k)], uniform=True,
                         n_buckets=1)[0] for k in range(10)]
    first = [D.bank_to_torch(b, "cpu") for b in banks]
    assert D.bank_to_torch(banks[0], "cpu") is not first[0]   # evicted
    monkeypatch.setattr(D, "_CACHE", {})
    D.cache_banks(5, 1)
    assert D._cache_max == 10
    D.cache_banks(1, 1)
    assert D._cache_max == 10
    first = [D.bank_to_torch(b, "cpu") for b in banks]
    assert all(D.bank_to_torch(b, "cpu") is t for b, t in zip(banks, first))


def test_check_names_the_card(monkeypatch):
    """A failed launch's error names the card it ran on."""
    from witch_tpu_torch import _build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "card %d" % i)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match=r"error 1 \(cuda:2, card 2\)"):
        _build.check(1, "forward", device=torch.device("cuda", 2))
    with pytest.raises(RuntimeError, match=r"\(cuda:0, card 0\)"):
        _build.check(1, "forward")
    n = _build.LAUNCHES["forward"]
    _build.check(0, "forward", device="cuda:2")
    assert _build.LAUNCHES["forward"] == n + 1
    _build.LAUNCHES["forward"] = n


def _card_grid():
    """A seeded bank of three models (Mp up to 160) and 301 queries of
    5-400 residues, made with the port's own modules (no JAX)."""
    from witch_tpu_torch.core.alphabet import DNA
    from witch_tpu_torch.hmm.bank import build_banks
    from witch_tpu_torch.hmm.build import build_hmm, quantize_like_text
    r = np.random.default_rng(15)
    cores = []
    for M_ in (60, 110, 150):
        base = r.integers(0, 4, M_)
        rows = []
        for _ in range(8):
            s = base.copy()
            mut = r.random(M_) < 0.12
            s[mut] = r.integers(0, 4, mut.sum())
            rows.append(s.astype(np.uint8))
        cores.append(quantize_like_text(build_hmm(np.array(rows), DNA,
                                                  "dna")))
    bank = build_banks(cores, uniform=True, n_buckets=1)[0]
    lens = r.integers(5, 400, 301).astype(np.int32)
    codes = np.zeros((301, 400), np.int32)
    for i, L in enumerate(lens):
        codes[i, :L] = r.integers(0, 4, L)
    return bank, codes, lens


def _on_card_identical(cards):
    from witch_tpu_torch import _build
    from witch_tpu_torch.ops.forward import forward_bits
    bank, codes, lens = _card_grid()
    single = forward_bits(D.bank_to_torch(bank, "cuda:0"), codes, lens)
    n = _build.LAUNCHES["forward"]
    got, ms = M.sharded_forward_bits(
        [D.bank_to_torch(bank, d) for d in cards], codes, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["forward"] == n + len(cards)
    assert len(ms) == len(cards) and all(m > 0 for m in ms)
    assert np.isfinite(got).all()
    assert np.array_equal(got, single)


@pytest.mark.cuda
def test_cache_entry_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bank, _, _ = _card_grid()
    with torch.cuda.device(0):
        assert D.bank_to_torch(bank, "cuda") is D.bank_to_torch(bank,
                                                                "cuda:0")
    assert D.resolve_device() == torch.device("cuda",
                                              torch.cuda.current_device())


@pytest.mark.cuda
def test_mesh_on_one_card_twice_bit_identical():
    """The split, the per-card launches and the gather on cuda:0 twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _on_card_identical([torch.device("cuda", 0)] * 2)


@pytest.mark.cuda
def test_mesh_over_real_cards_bit_identical():
    """Every visible card (at least two): np.array_equal to cuda:0 alone."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least 2 CUDA devices")
    _on_card_identical(M.data_mesh())
