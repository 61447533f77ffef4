"""Reference (numpy) posterior-decoding optimal-accuracy alignment.

Replaces the contract of `hmmalign -o out model query.fasta` as the
reference uses it (witch_msa/gcmm/aligner.py:96-142): align ONE query to a
profile and report, per query residue, whether it is match-emitted (and by
which match state) or insert/flank-emitted.

HMMER3 hmmalign = Forward/Backward -> posterior decode -> optimal accuracy
(OA) DP -> traceback. OA semantics: states carry expected-accuracy values
(>= 0); disallowed transitions contribute a 0 floor (not -inf); argmax ties
resolve first-candidate-wins in a fixed order. Profile mode calibrated
empirically against the bundled binary (tests/test_hmmalign_parity.py).
"""

from __future__ import annotations

import numpy as np

from .profile import Profile
from .forward_ref import forward_matrices, backward_matrices


def posterior_decode(prof: Profile, codes: np.ndarray):
    """Posterior probabilities of emitting residue i from each state."""
    fwd, F = forward_matrices(prof, codes)
    bck, B = backward_matrices(prof, codes)
    L = len(codes)
    loop, _ = prof.length_model(L)
    with np.errstate(invalid="ignore", over="ignore"):
        pp_M = np.exp(F["M"] + B["M"] - fwd)
        pp_I = np.exp(F["I"] + B["I"] - fwd)
        # N/C/J emit on their LOOP transition only: residue i is emitted by
        # X iff the path used X(i-1) -> X(i); the E->C / E->J arrival into
        # row i emits nothing.
        pp_N = np.zeros(L + 1)
        pp_J = np.zeros(L + 1)
        pp_C = np.zeros(L + 1)
        pp_N[1:] = np.exp(F["N"][:-1] + loop + B["N"][1:] - fwd)
        pp_J[1:] = np.exp(F["J"][:-1] + loop + B["J"][1:] - fwd)
        pp_C[1:] = np.exp(F["C"][:-1] + loop + B["C"][1:] - fwd)
    return dict(M=np.nan_to_num(pp_M), I=np.nan_to_num(pp_I),
                N=np.nan_to_num(pp_N), J=np.nan_to_num(pp_J),
                C=np.nan_to_num(pp_C), fwd=fwd, bck=bck)


FLT_MIN = 1.17549435e-38   # HMMER's TSCDELTA for disallowed transitions


def _deltas_u8(prof: Profile):
    def d(v):
        return (v > -np.inf).astype(np.uint8)
    return (d(prof.t_mm), d(prof.t_mi), d(prof.t_md), d(prof.t_im),
            d(prof.t_ii), d(prof.t_dm), d(prof.t_dd), d(prof.bm))


def oa_columns_from_pp(prof: Profile, pp) -> np.ndarray:
    """OA fill+trace -> aligned columns on the native C++ kernel
    (native/_oa)."""
    from ..native import _oa
    args = [np.ascontiguousarray(pp["M"], dtype=np.float64),
            np.ascontiguousarray(pp["I"], dtype=np.float64),
            np.ascontiguousarray(pp["N"], dtype=np.float64),
            np.ascontiguousarray(pp["J"], dtype=np.float64),
            np.ascontiguousarray(pp["C"], dtype=np.float64)]
    args += [np.ascontiguousarray(x) for x in _deltas_u8(prof)]
    return _oa.oa_align(*args, bool(prof.multihit))


def aligned_columns(prof: Profile, codes: np.ndarray) -> np.ndarray:
    """Per query residue: 0-based match-state column, or -1 if the residue
    is emitted by insert/flank states — the quantity WITCH derives from
    hmmalign's Stockholm output (aligner.py:126-142)."""
    pp = posterior_decode(prof, codes)
    return oa_columns_from_pp(prof, pp)
