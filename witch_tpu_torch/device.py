"""Device selection and the scoring bank on the device.

The host builds each bank as a ProfileBank (numpy, hmm/bank.py:
build_banks). bank_to_torch lays it out for the port's kernels and
plain versions: emission odds code-major [H, K, Mp]
(a gather by residue code reads contiguous states), transitions
[H, 8, Mp] in the row order mm mi md im ii dm dd bm, and the model
sizes. Counterpart of witch_tpu/ops/pallas_forward.py:device_bank_arrays
and bank_to_pallas_arrays, without the bf16 hi+lo split (that existed
for the TPU's matrix unit).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

TRANS_ROWS = ("t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm", "t_dd", "bm")
LANE = 32          # state-axis padding; padded states are inert (all zero)
_CACHE_MIN = 8     # banks kept resident at the least (cache_banks raises it)


def canonical_device(device) -> torch.device:
    """`device` as a torch.device with its card index: "cuda" names the
    current card, so "cuda" and that card's "cuda:i" are one device (one
    bank cache entry, one card of a mesh)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device=None) -> torch.device:
    """The device the pipeline runs on: CUDA (the current card, with its
    index), or an error.

    A caller that wants the plain CPU versions (the tests) passes
    device="cpu" explicitly; nothing falls back to the CPU on its own."""
    if device is not None:
        return canonical_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "witch_tpu_torch needs a CUDA device (torch.cuda.is_available() "
            "is False); pass device='cpu' explicitly to run the plain "
            "PyTorch versions")
    return canonical_device("cuda")


@dataclasses.dataclass
class BankTensors:
    em: torch.Tensor        # [H, K, Mp] f32 emission odds
    trans: torch.Tensor     # [H, 8, Mp] f32
    M: np.ndarray           # [H] i32 model sizes (host)
    pad_code: int           # first all-zero emission code (gap)
    # kernel-specific layouts of the tables, built at first use
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def H(self) -> int:
        return self.em.shape[0]

    @property
    def K(self) -> int:
        return self.em.shape[1]

    @property
    def Mp(self) -> int:
        return self.em.shape[2]

    @property
    def device(self) -> torch.device:
        return self.em.device


_CACHE: dict = {}
_cache_max = _CACHE_MIN


def cache_banks(n_banks: int, n_cards: int) -> None:
    """Size the bank cache for a job of n_banks banks on n_cards cards:
    it keeps at least twice that many (the job's banks on every card, and
    the previous job's beside them, so a resident server alternating two
    jobs re-uploads neither). The bound never shrinks."""
    global _cache_max
    _cache_max = max(_cache_max, 2 * n_banks * n_cards)


def _bank_key(bank, device) -> tuple:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(bank.em_odds).tobytes())
    for a in TRANS_ROWS + ("M",):
        h.update(np.ascontiguousarray(getattr(bank, a)).tobytes())
    return h.hexdigest(), str(canonical_device(device))


def bank_to_torch(bank, device) -> BankTensors:
    """ProfileBank -> BankTensors on `device`, cached by content hash and
    card (at least 8 banks are kept resident; cache_banks raises that)."""
    device = canonical_device(device)
    key = _bank_key(bank, device)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    H, Mp1, K = bank.em_odds.shape
    Mp = -(-Mp1 // LANE) * LANE
    em = np.zeros((H, K, Mp), np.float32)
    em[:, :, :Mp1] = np.transpose(bank.em_odds, (0, 2, 1))
    trans = np.zeros((H, 8, Mp), np.float32)
    for r, a in enumerate(TRANS_ROWS):
        trans[:, r, :Mp1] = getattr(bank, a)
    gaps = np.flatnonzero(np.abs(bank.em_odds).sum(axis=(0, 1)) == 0)
    hit = BankTensors(
        em=torch.from_numpy(em).to(device),
        trans=torch.from_numpy(trans).to(device),
        M=np.asarray(bank.M, np.int32).copy(),
        pad_code=int(gaps[0]) if len(gaps) else 0)
    while len(_CACHE) >= _cache_max:
        _CACHE.pop(next(iter(_CACHE)))
    _CACHE[key] = hit
    return hit
