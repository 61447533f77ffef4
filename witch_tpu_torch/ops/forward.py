"""All-vs-all Forward pre-scores: kernel (csrc/forward.cu), its plain
PyTorch version, and the bits wrapper.

Counterpart of witch_tpu/ops/pallas_forward.py (pallas_forward_nats,
pallas_forward_bits) and the dispatch of witch_tpu/hmm/forward.py:
score_bank. Every query runs exactly its own length, so no padding rows
enter the recurrence and the bits need no ploop correction
(pallas_forward.py:_bits_from_nats with Lpad = L).

The kernel runs one warp, or G warps for wide models, per (model, query)
pair; fwd_layout picks G, the states per lane and where the row and the
transitions live from the bank width, and slot_tables lays the bank out
for it. The queries are sorted by length (length_order) and each score
is written back at its original [q, h]; on the CPU the plain version
runs on the same sorted order and is scattered back the same way.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..device import BankTensors
from ._plain import SCALE_FLOOR, fwd_chain, fwd_chain_coeffs, shift_r

LN2 = math.log(2.0)
FWD_NPL = (8, 16, 24, 32, 40, 48)   # register layouts: states per lane
FWD_WARPS = 8                        # warps per CTA (csrc/forward.cu)
FWD_XS = 8                           # floats per warp of the row exchange


def fwd_layout(Mp: int):
    """(layout, G warps per pair, npl states per lane, Mpad) for a bank
    of width Mp. Layout 0: the row in registers, G warps of at most 48
    states per lane, the transitions in shared memory, whenever they fit
    there. Layout 1 (wider): one pair of 8 warps per CTA, its row in
    shared memory, the transitions in device memory."""
    G = -(-Mp // (32 * FWD_NPL[-1]))
    if G <= FWD_WARPS:
        need = -(-Mp // (32 * G))
        npl = min(n for n in FWD_NPL if n >= need)
        Mpad = 32 * G * npl
        wp = max(1, FWD_WARPS // G)
        if 4 * (8 * Mpad + 2 * wp * G * FWD_XS + wp * G * 4) \
                <= _build.SMEM_ROWS_MAX:
            return 0, G, npl, Mpad
    G = FWD_WARPS
    npl = -(-Mp // (32 * G))
    Mpad = 32 * G * npl
    if 4 * (3 * Mpad + 2 * G * FWD_XS + G * 4) > _build.SMEM_ROWS_MAX:
        raise ValueError("forward kernel: Mp %d exceeds the widest layout"
                         % Mp)
    return 1, G, npl, Mpad


def slot_index(Mp: int, G: int, npl: int) -> np.ndarray:
    """[Mpad] int64: the state k held at each slot of the kernel's layout
    (slot (j*G + g)*32 + lane holds k = (g*32 + lane)*npl + j), -1 where
    the slot lies beyond Mp."""
    j, g, lane = np.meshgrid(np.arange(npl), np.arange(G), np.arange(32),
                             indexing="ij")
    k = ((g * 32 + lane) * npl + j).reshape(-1)
    return np.where(k < Mp, k, -1)


def slot_tables(bt: BankTensors, G: int, npl: int):
    """Emission [H, K, Mpad] and transition [H, 8, Mpad] tables in the
    kernel's slot layout (zero beyond Mp), cached on the bank."""
    key = ("fwd_slots", G, npl)
    hit = bt.cache.get(key)
    if hit is None:
        k = slot_index(bt.Mp, G, npl)
        src = torch.as_tensor(np.maximum(k, 0), device=bt.device)
        live = torch.as_tensor(k >= 0, device=bt.device)
        hit = tuple((t.index_select(2, src) * live).contiguous()
                    for t in (bt.em, bt.trans))
        bt.cache[key] = hit
    return hit


def length_order(qlens: torch.Tensor) -> torch.Tensor:
    """Query indices sorted by length, longest first (stable), int32."""
    return torch.sort(qlens.to(torch.int64), descending=True,
                      stable=True).indices.to(torch.int32)


def forward_nats_ref(bt: BankTensors, codes: torch.Tensor,
                     qlens: torch.Tensor, elems: int = 1 << 24
                     ) -> torch.Tensor:
    """Plain version: multihit Forward nats [Q, H] (f32), query chunks
    of at most `elems` DP cells per row."""
    H, Mp = bt.H, bt.Mp
    tr = bt.trans[:, :, None, :]                 # [H, 8, 1, Mp]
    tmm, tmi, tmd, tim, tii, tdm, tdd, bm = (tr[:, r] for r in range(8))
    A = fwd_chain_coeffs(tdd)
    Q = codes.shape[0]
    out = torch.empty((Q, H), dtype=torch.float32, device=codes.device)
    qc = max(1, elems // max(1, H * Mp))
    for q0 in range(0, Q, qc):
        c = codes[q0:q0 + qc].long()
        ql = qlens[q0:q0 + qc]
        n = c.shape[0]
        Lf = ql.to(torch.float32)[None, :]                 # [1, n]
        pmove = 3.0 / (Lf + 3.0)
        ploop = 1.0 - pmove
        z = torch.zeros((H, n, Mp), dtype=torch.float32, device=c.device)
        M, I, D = z, z, z
        N = torch.ones((H, n), device=c.device)
        B = pmove.expand(H, n).clone()
        J = torch.zeros((H, n), device=c.device)
        C = torch.zeros((H, n), device=c.device)
        logs = torch.zeros((H, n), device=c.device)
        for i in range(int(ql.max().item()) if n else 0):
            e = bt.em.index_select(1, c[:, i].clamp(min=0))   # [H, n, Mp]
            src = shift_r(M * tmm + I * tim + D * tdm) + B[..., None] * bm
            Mr = src * e
            Ir = M * tmi + I * tii
            Dr = fwd_chain(shift_r(Mr * tmd), A)
            E = Mr.sum(-1) + Dr.sum(-1)
            Jn = J * ploop + E * 0.5
            Cn = C * ploop + E * 0.5
            Nn = N * ploop
            Bn = Nn * pmove + Jn * pmove
            scale = torch.maximum(Mr.amax(-1), torch.maximum(
                Cn, Nn.clamp(min=SCALE_FLOOR)))
            inv = 1.0 / scale
            keep = (i < ql)[None, :]
            k3 = keep[..., None]
            M = torch.where(k3, Mr * inv[..., None], M)
            I = torch.where(k3, Ir * inv[..., None], I)
            D = torch.where(k3, Dr * inv[..., None], D)
            N = torch.where(keep, Nn * inv, N)
            B = torch.where(keep, Bn * inv, B)
            J = torch.where(keep, Jn * inv, J)
            C = torch.where(keep, Cn * inv, C)
            logs = torch.where(keep, logs + torch.log(scale), logs)
        out[q0:q0 + n] = (torch.log(C * pmove) + logs).T
    return out


def forward_nats(bt: BankTensors, codes: torch.Tensor,
                 qlens: torch.Tensor, events=None) -> torch.Tensor:
    """Forward nats [Q, H]: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; both take the queries in length order and
    return the scores in the caller's order. `events`: two CUDA events,
    recorded just before and just after the kernel's launch."""
    dev = bt.device
    if codes.device != dev or qlens.device != dev:
        raise ValueError("bank, codes and qlens must share a device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    codes = codes.to(torch.int32).contiguous()
    qlens = qlens.to(torch.int32).contiguous()
    if codes.dim() != 2 or qlens.shape != (codes.shape[0],):
        raise ValueError("codes [Q, L] and qlens [Q] expected")
    Q = codes.shape[0]
    out = torch.empty((Q, bt.H), dtype=torch.float32, device=dev)
    if Q == 0 or bt.H == 0:
        return out
    order = length_order(qlens)
    if dev.type == "cpu":
        o = order.long()
        out[o] = forward_nats_ref(bt, codes[o], qlens[o])
        return out
    layout, G, npl, Mpad = fwd_layout(bt.Mp)
    em_t, tr_t = slot_tables(bt, G, npl)
    lib = _build.lib()
    with _build.on_card(dev):
        if events is not None:
            events[0].record()
        rc = lib.witch_forward_nats(
            em_t.data_ptr(), tr_t.data_ptr(), codes.data_ptr(),
            qlens.data_ptr(), order.data_ptr(), out.data_ptr(), bt.H, Q,
            bt.K, codes.shape[1], layout, G, npl, Mpad,
            _build.stream_ptr(dev))
        if events is not None:
            events[1].record()
    _build.check(rc, "forward", device=dev)
    return out


def null1_bits(qlens: np.ndarray) -> np.ndarray:
    L = np.asarray(qlens, np.float64)
    p1 = L / (L + 1.0)
    return (L * np.log(p1) + np.log(1.0 - p1)) / LN2


@dataclasses.dataclass
class PendingForward:
    """A started forward_nats call (forward_launch): its nats [Q, H] on
    the bank's device, the query lengths, and the CUDA events around the
    kernel's launch (None on the CPU, where ms is the plain version's
    host time)."""
    nats: torch.Tensor
    qlens: np.ndarray
    events: Optional[tuple] = None
    ms: float = 0.0

    def kernel_ms(self) -> float:
        """The kernel's CUDA-event ms once forward_collect has returned
        (the plain version's host ms on the CPU)."""
        if self.events is None:
            return self.ms
        return self.events[0].elapsed_time(self.events[1])


def forward_launch(bt: BankTensors, codes: np.ndarray,
                   qlens: np.ndarray) -> PendingForward:
    """The launch half of forward_bits: the queries copied to the bank's
    device and the kernel started there, with that card current; returns
    without waiting for the kernel (the plain version, on the CPU, runs
    to its end)."""
    dev = bt.device
    qlens = np.asarray(qlens)
    with _build.on_card(dev):
        c = torch.as_tensor(np.asarray(codes), dtype=torch.int32,
                            device=dev)
        l = torch.as_tensor(qlens, dtype=torch.int32, device=dev)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            nats = forward_nats(bt, c, l)
            return PendingForward(nats, qlens,
                                  ms=(time.perf_counter() - t0) * 1e3)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        nats = forward_nats(bt, c, l, events=ev)
    return PendingForward(nats, qlens, ev if nats.numel() else None)


def forward_collect(p: PendingForward) -> np.ndarray:
    """The collect half: waits for the kernel, adds its CUDA-event ms to
    _build.KERNEL_MS["forward"] and returns the bits (f64, host)."""
    nats = p.nats.double().cpu().numpy()
    if p.events is not None:
        _build.KERNEL_MS["forward"] += p.kernel_ms()
    return nats / LN2 - null1_bits(p.qlens)[:, None]


def forward_bits(bt: BankTensors, codes: np.ndarray,
                 qlens: np.ndarray) -> np.ndarray:
    """Null1-corrected pre-score bits [Q, H] (f64, host): the contract
    of witch_tpu/ops/pallas_forward.py:pallas_forward_bits."""
    return forward_collect(forward_launch(bt, codes, qlens))
