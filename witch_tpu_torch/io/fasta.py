"""FASTA / gzip IO.

Behavioral contract from the reference reader (alignment_tools.py:59-113):
  * `.gz` / `.gzip` suffix selects gzip text mode
  * header = text after '>' stripped; sequence lines joined with internal
    whitespace removed; case preserved
  * writer emits '>name\\nseq\\n' per record
"""

from __future__ import annotations

import gzip
import io
from typing import Iterable, Iterator, Tuple


def _open_text(path_or_obj, mode: str):
    if isinstance(path_or_obj, str):
        suffix = path_or_obj.strip().split(".")[-1]
        if suffix in ("gz", "gzip"):
            return gzip.open(path_or_obj, mode + "t"), True
        return open(path_or_obj, mode), True
    return path_or_obj, False


def read_fasta(src, remove_gaps: bool = False) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) from a FASTA path or file object."""
    fobj, should_close = _open_text(src, "r")
    try:
        name = None
        chunks = []
        for line in fobj:
            if line.startswith(">"):
                if name is not None:
                    seq = "".join(chunks)
                    yield name, seq.replace("-", "") if remove_gaps else seq
                name = line[1:].strip()
                chunks = []
            else:
                chunks.append("".join(line.strip().split()))
        if name is not None:
            seq = "".join(chunks)
            yield name, seq.replace("-", "") if remove_gaps else seq
    finally:
        if should_close:
            fobj.close()


def write_fasta_bytes(names, mat, dest):
    """Write rows of a uint8 ASCII matrix as FASTA (no string
    round-trip; the merge stage's output writer)."""
    import numpy as np
    if isinstance(dest, str) and dest.endswith(".gz"):
        import gzip as _gz
        with _gz.open(dest, "wb", compresslevel=6) as f:
            for name, row in zip(names, np.asarray(mat)):
                f.write(b">" + name.encode("latin-1") + b"\n"
                        + row.tobytes() + b"\n")
        return
    with open(dest, "wb") as f:
        for name, row in zip(names, np.asarray(mat)):
            f.write(b">" + name.encode("latin-1") + b"\n"
                    + row.tobytes() + b"\n")


def write_fasta(records: Iterable[Tuple[str, str]], dest, zipout: bool = False):
    """Write (name, seq) records to a path or file object."""
    if isinstance(dest, str):
        if zipout or dest.endswith(".gz"):
            with gzip.open(dest, "wt", compresslevel=6) as f:
                for name, seq in records:
                    f.write(">%s\n%s\n" % (name, seq))
        else:
            with open(dest, "w") as f:
                for name, seq in records:
                    f.write(">%s\n%s\n" % (name, seq))
    else:
        for name, seq in records:
            dest.write(">%s\n%s\n" % (name, seq))
