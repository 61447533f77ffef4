"""HMMER3 text model format (.hmm) reader/writer.

Interop with the reference ecosystem: the reference parses NSEQ from these
files (witch_msa/gcmm/loader.py:39-58) and `--keep-decomposition` reruns
re-read saved models. We also use this format to cross-validate our build
kernel against the bundled hmmbuild binary during calibration tests.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.alphabet import ALPHABETS
from ..hmm.build import CoreHMM

_ALPH_NAME = {"dna": "DNA", "rna": "RNA", "amino": "amino"}
_NAME_ALPH = {"DNA": "dna", "RNA": "rna", "amino": "amino"}


def _fmt(p: float) -> str:
    if p == 0.0:
        return "*"
    v = -math.log(p)
    if v == 0.0:
        v = 0.0
    return "%.5f" % v


def _fmt_rows(arr, sep="  "):
    """Rows of '%.5f'-formatted -log(p) ('*' at p=0), sep-joined.
    Native formatter when built (the per-element Python path costs
    ~3.6 s for the example ensemble's 141 models)."""
    import numpy as np
    a = np.ascontiguousarray(arr, np.float64)
    try:
        from ..native import _domaindef
        return _domaindef.format_nats_rows(a, sep)
    except (ImportError, AttributeError):
        return [sep.join(_fmt(p) for p in row) for row in a]


def write_hmm(hmm: CoreHMM, path: str, extra_header: Optional[dict] = None):
    M, K = hmm.M, hmm.K
    alph = _ALPH_NAME[hmm.molecule]
    letters = ALPHABETS[hmm.molecule].canonical
    with open(path, "w") as f:
        f.write("HMMER3/f [3.1b2 | February 2015]\n")
        f.write("NAME  %s\n" % (hmm.name or "model"))
        f.write("LENG  %d\n" % M)
        f.write("ALPH  %s\n" % alph)
        f.write("RF    no\nMM    no\nCONS  yes\nCS    no\nMAP   %s\n"
                % ("yes" if hmm.map_to_columns is not None else "no"))
        f.write("NSEQ  %d\n" % hmm.nseq)
        f.write("EFFN  %f\n" % hmm.effn)
        if extra_header:
            for k, v in extra_header.items():
                f.write("%-5s %s\n" % (k, v))
        # STATS lines are required by HMMER binaries to compute E-values;
        # scores themselves do not depend on them. We emit placeholder
        # Gumbel/exponential parameters for interop.
        f.write("STATS LOCAL MSV      -10.0000  0.70000\n")
        f.write("STATS LOCAL VITERBI  -10.0000  0.70000\n")
        f.write("STATS LOCAL FORWARD   -5.0000  0.70000\n")
        f.write("HMM      %s\n" % "        ".join(letters))
        f.write("            m->m     m->i     m->d     i->m     i->i"
                "     d->m     d->d\n")
        # COMPO: average match emission composition (occupancy-unweighted
        # approximation; not used by our pipeline)
        compo = hmm.match_emissions[1:].mean(axis=0)
        f.write("  COMPO   %s\n" % _fmt_rows(compo[None, :])[0])
        mat_rows = _fmt_rows(hmm.match_emissions)
        ins_rows = _fmt_rows(hmm.insert_emissions)
        tr_rows = _fmt_rows(hmm.trans)
        f.write("          %s\n" % ins_rows[0])
        f.write("          %s\n" % tr_rows[0])
        parts = []
        for k in range(1, M + 1):
            mapv = (str(int(hmm.map_to_columns[k - 1]) + 1)
                    if hmm.map_to_columns is not None else "-")
            cons = hmm.consensus[k - 1] if hmm.consensus else "-"
            parts.append("%7d   %s %6s %s - - -\n" % (
                k, mat_rows[k], mapv, cons))
            parts.append("          %s\n" % ins_rows[k])
            parts.append("          %s\n" % tr_rows[k])
        f.write("".join(parts))
        f.write("//\n")


def _parse_probs(tokens):
    out = []
    for t in tokens:
        if t == "*":
            out.append(0.0)
        else:
            out.append(math.exp(-float(t)))
    return np.array(out)


def read_hmm(path: str) -> CoreHMM:
    with open(path) as f:
        lines = f.read().split("\n")
    header = {}
    i = 0
    while not lines[i].startswith("HMM "):
        parts = lines[i].split(None, 1)
        if len(parts) == 2:
            header.setdefault(parts[0], parts[1].strip())
        i += 1
    molecule = _NAME_ALPH[header["ALPH"]]
    K = len(ALPHABETS[molecule].canonical)
    M = int(header["LENG"])
    i += 2  # skip HMM header + transition header lines
    if lines[i].strip().startswith("COMPO"):
        i += 1
    ins0 = _parse_probs(lines[i].split())
    i += 1
    t0 = _parse_probs(lines[i].split())
    i += 1
    mat = np.zeros((M + 1, K))
    ins = np.zeros((M + 1, K))
    trans = np.zeros((M + 1, 7))
    ins[0] = ins0
    trans[0] = t0
    mapping = np.full(M, -1, dtype=np.int64)
    cons = []
    for k in range(1, M + 1):
        tok = lines[i].split()
        assert int(tok[0]) == k, (path, k, tok[:2])
        mat[k] = _parse_probs(tok[1:1 + K])
        rest = tok[1 + K:]
        if rest and rest[0] != "-":
            try:
                mapping[k - 1] = int(rest[0]) - 1
            except ValueError:
                pass
        if len(rest) > 1:
            cons.append(rest[1])
        i += 1
        ins[k] = _parse_probs(lines[i].split())
        i += 1
        trans[k] = _parse_probs(lines[i].split())
        i += 1
    return CoreHMM(
        match_emissions=mat, insert_emissions=ins, trans=trans,
        nseq=int(header.get("NSEQ", 0)),
        effn=float(header.get("EFFN", 0.0)),
        molecule=molecule, name=header.get("NAME", ""),
        map_to_columns=mapping if (mapping >= 0).any() else None,
        consensus="".join(cons) if cons else None)
