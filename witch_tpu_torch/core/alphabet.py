"""Biological alphabets with degeneracy handling, encoded for array kernels.

TPU-first re-design of the reference's string-level handling (reference:
witch_msa/helpers/alignment_tools.py:118-143 for type inference). Sequences
are encoded to uint8 code arrays once at the IO boundary; all downstream
compute is on arrays.

Code layout (matching HMMER/easel conventions so profile math is direct):
  0..K-1      canonical residues
  GAP_CODE    gap ('-', '.', '_', '~')
  K..         degenerate codes (each expands to a subset of canonicals)
  MISSING     unknown characters map to the fully-degenerate "any" code
"""

from __future__ import annotations

import dataclasses
import numpy as np

GAP_CHARS = "-._~"


@dataclasses.dataclass(frozen=True)
class Alphabet:
    name: str
    canonical: str                     # canonical residue letters, len K
    degenerate: dict                   # letter -> string of canonical letters
    K: int = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "K", len(self.canonical))
        # Build lookup tables.
        # ascii -> code. Codes: 0..K-1 canonical, K = gap, K+1.. degenerate.
        to_code = np.full(256, -1, dtype=np.int16)
        letters = list(self.canonical)
        deg_letters = sorted(self.degenerate.keys())
        code_of = {c: i for i, c in enumerate(letters)}
        gap_code = self.K
        for ch in GAP_CHARS:
            to_code[ord(ch)] = gap_code
        for i, c in enumerate(letters):
            to_code[ord(c)] = i
            to_code[ord(c.lower())] = i
        ndeg = len(deg_letters)
        # degeneracy expansion matrix: rows = all codes, cols = canonical
        # expand[c, a] = 1/|set| if canonical a is in the expansion of code c
        expand = np.zeros((self.K + 1 + ndeg, self.K), dtype=np.float64)
        expand[np.arange(self.K), np.arange(self.K)] = 1.0
        for j, c in enumerate(deg_letters):
            code = self.K + 1 + j
            members = self.degenerate[c]
            for a in members:
                expand[code, code_of[a]] = 1.0 / len(members)
            to_code[ord(c)] = code
            to_code[ord(c.lower())] = code
        object.__setattr__(self, "_to_code", to_code)
        object.__setattr__(self, "_expand", expand)
        object.__setattr__(self, "gap_code", gap_code)
        object.__setattr__(self, "num_codes", self.K + 1 + ndeg)
        object.__setattr__(self, "any_code",
                           int(to_code[ord(self.any_letter)]))

    @property
    def any_letter(self) -> str:
        return "N" if self.name in ("dna", "rna") else "X"

    def encode(self, seq: str) -> np.ndarray:
        """Encode a sequence string to a uint8 code array.

        Unknown characters are treated as the fully-degenerate residue, the
        same leniency HMMER applies to rare junk characters.
        """
        raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
        codes = self._to_code[raw]
        codes = np.where(codes < 0, self.any_code, codes)
        return codes.astype(np.uint8)

    def expansion_matrix(self) -> np.ndarray:
        """[num_codes, K] float64: fractional count distribution per code.

        Gap rows are all-zero. Canonical rows are one-hot. Degenerate rows
        spread 1/n over their n members (HMMER's esl_abc_FCount behavior).
        """
        return self._expand

    def is_gap(self, codes: np.ndarray) -> np.ndarray:
        return codes == self.gap_code

    def is_residue(self, codes: np.ndarray) -> np.ndarray:
        return codes != self.gap_code

    def decode(self, codes: np.ndarray) -> str:
        table = self.code_letters()
        return "".join(table[c] for c in codes)

    def code_letters(self):
        letters = list(self.canonical) + ["-"] + sorted(self.degenerate)
        return letters


DNA = Alphabet(
    name="dna",
    canonical="ACGT",
    degenerate={
        "R": "AG", "Y": "CT", "M": "AC", "K": "GT", "S": "CG", "W": "AT",
        "H": "ACT", "B": "CGT", "V": "ACG", "D": "AGT", "N": "ACGT",
        # easel maps U onto T for DNA
        "U": "T",
    },
)

RNA = Alphabet(
    name="rna",
    canonical="ACGU",
    degenerate={
        "R": "AG", "Y": "CU", "M": "AC", "K": "GU", "S": "CG", "W": "AU",
        "H": "ACU", "B": "CGU", "V": "ACG", "D": "AGU", "N": "ACGU",
        "T": "U",
    },
)

AMINO = Alphabet(
    name="amino",
    canonical="ACDEFGHIKLMNPQRSTVWY",
    degenerate={
        "B": "DN", "J": "IL", "Z": "EQ",
        "X": "ACDEFGHIKLMNPQRSTVWY",
        # easel: U (selenocysteine) -> C, O (pyrrolysine) -> K
        "U": "C", "O": "K",
    },
)

ALPHABETS = {"dna": DNA, "rna": RNA, "amino": AMINO}


def infer_datatype(seqs) -> str:
    """Infer dna/rna/amino from an iterable of (name, ungapped seq).

    Same decision rule as the reference (alignment_tools.py:118-143):
    >90% ACGN+T with no U => dna; >90% ACGN+U with no T => rna; else amino.
    """
    acg = t = u = total = 0
    for _, seq in seqs:
        for ch in seq.upper():
            total += 1
            if ch in ("A", "C", "G", "N"):
                acg += 1
            elif ch == "T":
                t += 1
            elif ch == "U":
                u += 1
    if total == 0:
        return "dna"
    if u == 0 and (acg + t) / total > 0.9:
        return "dna"
    if t == 0 and (acg + u) / total > 0.9:
        return "rna"
    return "amino"
