"""Array-backed multiple sequence alignment containers.

TPU-first re-design: the reference keeps alignments as dicts of Python
strings (witch_msa/helpers/alignment_tools.py:146-341). Here an alignment is
a uint8 code matrix [n_seqs, n_cols] plus a name list, so column reductions,
sub-alignments and count accumulations are vectorized numpy ops and feed
directly into device kernels.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.alphabet import ALPHABETS, Alphabet, infer_datatype
from ..io.fasta import read_fasta, write_fasta


class PackedAlignment:
    """names + uint8 [n, L] code matrix (aligned; may hold gap codes)."""

    def __init__(self, names: List[str], codes: np.ndarray, alphabet: Alphabet):
        assert codes.ndim == 2 and len(names) == codes.shape[0]
        self.names = list(names)
        self.codes = codes
        self.alphabet = alphabet
        self._index: Optional[Dict[str, int]] = None

    # ---------------------------------------------------------------- IO
    @classmethod
    def from_records(cls, records: Iterable[Tuple[str, str]],
                     alphabet: Optional[Alphabet] = None,
                     molecule: Optional[str] = None) -> "PackedAlignment":
        records = list(records)
        if alphabet is None:
            if molecule is None:
                molecule = infer_datatype(
                    (n, s.replace("-", "")) for n, s in records)
            alphabet = ALPHABETS[molecule]
        names = [n for n, _ in records]
        if not records:
            return cls(names, np.zeros((0, 0), dtype=np.uint8), alphabet)
        L = len(records[0][1])
        mat = np.empty((len(records), L), dtype=np.uint8)
        for i, (_, s) in enumerate(records):
            if len(s) != L:
                raise ValueError(
                    "unaligned input: row %d has length %d != %d"
                    % (i, len(s), L))
            mat[i] = alphabet.encode(s)
        return cls(names, mat, alphabet)

    @classmethod
    def from_fasta(cls, path, alphabet: Optional[Alphabet] = None,
                   molecule: Optional[str] = None) -> "PackedAlignment":
        return cls.from_records(read_fasta(path), alphabet, molecule)

    def to_records(self) -> Iterable[Tuple[str, str]]:
        # vectorized decode: code -> ascii byte lookup, one bytes->str
        # per row (the per-character join cost ~0.8 s for the example
        # ensemble's 141 subset FASTA artifacts)
        table = np.frombuffer(
            "".join(self.alphabet.code_letters()).encode("latin-1"),
            dtype=np.uint8)
        rows = table[self.codes]
        for i, name in enumerate(self.names):
            yield name, rows[i].tobytes().decode("latin-1")

    def to_bytes_matrix(self) -> np.ndarray:
        """Decoded [n_rows, n_cols] uint8 ASCII matrix (no string
        round-trip — the merge stage overlays bytes directly)."""
        table = np.frombuffer(
            "".join(self.alphabet.code_letters()).encode("latin-1"),
            dtype=np.uint8)
        return table[self.codes]

    def write(self, dest, zipout: bool = False):
        write_fasta(self.to_records(), dest, zipout=zipout)

    # ------------------------------------------------------------ queries
    @property
    def n_seqs(self) -> int:
        return self.codes.shape[0]

    @property
    def n_cols(self) -> int:
        return self.codes.shape[1]

    def index_of(self, name: str) -> int:
        if self._index is None:
            self._index = {n: i for i, n in enumerate(self.names)}
        return self._index[name]

    def row_string(self, name: str) -> str:
        table = np.array(self.alphabet.code_letters(), dtype="U1")
        return "".join(table[self.codes[self.index_of(name)]])

    def gap_mask(self) -> np.ndarray:
        return self.codes == self.alphabet.gap_code

    def sub_alignment(self, names: Sequence[str]) -> "PackedAlignment":
        rows = [self.index_of(n) for n in names if n in self._name_set()]
        return PackedAlignment([self.names[r] for r in rows],
                               self.codes[rows], self.alphabet)

    def _name_set(self):
        if self._index is None:
            self._index = {n: i for i, n in enumerate(self.names)}
        return self._index

    def delete_all_gap_columns(self) -> Tuple["PackedAlignment", np.ndarray]:
        """Drop columns that are gaps in every row.

        Returns (new alignment, retained column indices) — the reference's
        `delete_all_gaps()` contract (alignment_tools.py:277-281).
        """
        nongap = ~self.gap_mask()
        keep = np.flatnonzero(nongap.any(axis=0))
        return (PackedAlignment(self.names, self.codes[:, keep],
                                self.alphabet), keep)

    def nongaps_per_column(self) -> np.ndarray:
        """#non-gap characters per column (DP edge weights in the merge;
        reference algorithm.py:426-429)."""
        return (~self.gap_mask()).sum(axis=0).astype(np.int64)

    def ungapped_lengths(self) -> np.ndarray:
        return (~self.gap_mask()).sum(axis=1).astype(np.int64)


def subset_counts(backbone: PackedAlignment,
                  names: Sequence[str]) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """For a backbone subset: (row indices, retained columns, nongaps/col).

    Mirrors reference subset_alignment_and_hmmbuild bookkeeping
    (algorithm.py:394-429) without materializing the subalignment.
    """
    rows = np.array([backbone.index_of(n) for n in names], dtype=np.int64)
    sub = backbone.codes[rows]
    nongap = sub != backbone.alphabet.gap_code
    per_col = nongap.sum(axis=0)
    retained = np.flatnonzero(per_col > 0)
    return rows, retained, per_col[retained].astype(np.int64)
