"""Time the port's Forward scoring kernel on the bench grid under other
(warps per pair, states per lane) layouts than the one
witch_tpu_torch.ops.forward.fwd_layout picks, on one CUDA card.

    python3 witch_tpu_torch/tools/forward_layouts.py

For each bank of bench_assets.npz (Mp 1,312 and 2,720) and each
register layout (G warps per pair, npl states per lane) that covers the
bank and whose transitions fit in shared memory, it prints one JSON
line: CUDA-event ms (mean of 5 launches after a warm-up) and the
largest |dbits| against the chosen layout's scores.
"""

import json
import os
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import witch_tpu_torch.ops.forward as F  # noqa: E402
from witch_tpu_torch import _build  # noqa: E402
from witch_tpu_torch.device import bank_to_torch  # noqa: E402

CANDIDATES = [(1, 48), (2, 24), (2, 32), (2, 48), (3, 16), (3, 32), (4, 16),
              (4, 24), (6, 16), (8, 8), (8, 16)]


def main():
    z = np.load(os.path.join(ROOT, "bench_assets.npz"))
    fields = ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm",
              "t_dd", "bm", "M")
    dev = torch.device("cuda")
    c = torch.from_numpy(z["codes"]).to(dev)
    ln = torch.from_numpy(z["lens"]).to(dev)
    chosen = F.fwd_layout

    def ms(bt, reps=5):
        F.forward_nats(bt, c, ln)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            F.forward_nats(bt, c, ln)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / reps

    for i in range(int(z["n_banks"])):
        b = types.SimpleNamespace(**{f: z["bank%d_%s" % (i, f)]
                                     for f in fields})
        bt = bank_to_torch(b, dev)
        ref = F.forward_nats(bt, c, ln)
        for G, npl in CANDIDATES:
            Mpad = 32 * G * npl
            wp = max(1, F.FWD_WARPS // G)
            smem = 4 * (8 * Mpad + 2 * wp * G * F.FWD_XS + wp * G * 4)
            if Mpad < bt.Mp or smem > _build.SMEM_ROWS_MAX:
                continue
            F.fwd_layout = lambda Mp, G=G, npl=npl, Mpad=Mpad: (0, G, npl,
                                                                  Mpad)
            try:
                got = F.forward_nats(bt, c, ln)
                err = float(((got - ref).abs() / F.LN2).max())
                print(json.dumps(dict(Mp=bt.Mp, G=G, npl=npl,
                                      chosen=chosen(bt.Mp)[1:3] == (G, npl),
                                      ms=ms(bt), max_dbits=err)), flush=True)
            finally:
                F.fwd_layout = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
