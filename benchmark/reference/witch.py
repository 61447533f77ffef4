"""WITCH's answers for a few fragments, worked out again from the backbone,
its tree and the fragments alone.

For each fragment:
  1. its Forward score against every model of the ensemble (multihit
     local, hmmsearch's configuration), null1-corrected, in bits;
  2. the candidates that WITCH's scoring evaluates: the top models by
     score + log2(model size), the first num_hmms + 4 when all of those
     score >= 0 bits, else max(18, num_hmms + 8);
  3. each candidate's reported score (hmmsearch's): domain definition on
     the multihit posteriors (regions where the match occupancy rises
     above 0.25 and stays above 0.10), each region rescored alone with
     its null2 correction, the sequence bias, and the per-domain
     reconstruction score where it is higher (an envelope is rescored
     alone with the unihit model, configured for the whole fragment's
     length); a candidate with no region
     is not reported (the gate). A region that holds more than one domain
     (split mass >= 0.2) is resolved by HMMER with a stochastic trace
     ensemble, which this reference does not reproduce: such a pair is
     "undecided" and its fragment is left out of the weight comparison;
  4. the walk down the ranked candidates that drops gated pairs until
     num_hmms are accepted, scores rounded to 0.1 bit, and the weights
     (UPP's): w_i = 1 / sum_j 2^(s_j - s_i) size_j / size_i, the top
     num_hmms kept;
  5. its row: for the models and weights given, hmmalign's alignment of
     the fragment to each model (unihit local posterior decoding and the
     optimal-accuracy path), each residue's match state mapped to its
     backbone column, and witch-ng's merge: the maximum-weight
     alignment of residues to columns over the edges weighted by the
     column's residue count in the subset times the model's weight; the
     masked row keeps the residues placed on backbone columns.

Unevaluated pairs keep their Forward score less the null2 floor
log2(1 + 1/256), as WITCH's scoring does.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from . import dp

LN2 = math.log(2.0)
RT1, RT2, RT3 = 0.25, 0.10, 0.20
BIAS_FLOOR_BITS = math.log2(1.0 + dp.OMEGA)
CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def encode(seq):
    return np.array([CODE[c] for c in seq.upper()], np.int64)


def null1(L):
    p1 = L / (L + 1.0)
    return L * math.log(p1) + math.log(1.0 - p1)


def _chunks(items, per_item_bytes, budget):
    n = max(1, int(budget // max(per_item_bytes, 1)))
    for s in range(0, len(items), n):
        yield items[s:s + n]


def _budget(device):
    """Bytes a batch's matrices may take: half of the card's free memory
    (the program is done when the reference runs), 2 GiB on the CPU."""
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info(torch.device(device))[0] // 2
    return 2 << 30


class Reference:
    def __init__(self, models, device, dtype=torch.float64,
                 budget_bytes=None):
        self.models = models
        self.idx = sorted(models)
        self.prof = {i: dp.configure(models[i]) for i in self.idx}
        self.device, self.dtype = device, dtype
        self.budget = budget_bytes or _budget(device)
        self.esize = torch.tensor([], dtype=dtype).element_size()

    def _batch(self, pairs, Lmodel=None):
        return dp.Batch([self.prof[h] for h, _ in pairs],
                        [c for _, c in pairs], self.dtype, self.device,
                        Lmodel)

    # 1. Forward scores
    def prescores(self, codes_list):
        """[Q, H] Forward bits (fwd - null1) / ln2."""
        pairs = [(h, c) for c in codes_list for h in self.idx]
        M1 = max(self.models[h].M for h in self.idx) + 1
        out = []
        for chunk in _chunks(pairs, 12 * M1 * self.esize, self.budget):
            fwd, _, _ = dp.forward(self._batch(chunk), "multi")
            out.append(fwd.double().cpu().numpy())
        fwd = np.concatenate(out).reshape(len(codes_list), len(self.idx))
        n1 = np.array([null1(len(c)) for c in codes_list])
        return (fwd - n1[:, None]) / LN2

    # 3. reported scores of candidate pairs
    def reported(self, pairs):
        """[(bits or None when undecided, gate_ok)] of (model, codes) pairs."""
        res = [None] * len(pairs)
        regions_of = {}
        M1 = max(self.models[h].M for h, _ in pairs) + 1
        Lm = max(len(c) for _, c in pairs) + 1
        order = list(range(len(pairs)))
        for chunk in _chunks(order, 16 * M1 * self.esize + 64 * Lm,
                             self.budget):
            bt = self._batch([pairs[p] for p in chunk])
            fwd, fsp, _ = dp.forward(bt, "multi")
            post, _ = dp.backward(bt, "multi", fwd, fsp)
            post = {n: v.double().cpu().numpy() for n, v in post.items()}
            fwd = fwd.double().cpu().numpy()
            for b, p in enumerate(chunk):
                L = len(pairs[p][1])
                mocc = 1.0 - (post["N"][b, :L + 1] + post["J"][b, :L + 1]
                              + post["C"][b, :L + 1])
                mocc[0] = 0.0
                ppB, ppE = post["B"][b, :L + 1], post["E"][b, :L + 1]
                regs = find_regions(mocc, ppB, ppE)
                btot = np.cumsum(np.concatenate([[0.0], ppB[:-1]]))
                etot = np.cumsum(np.concatenate([[0.0], ppE[1:]]))
                multi = any(split_mass(btot, etot, i, j) >= RT3
                            for i, j in regs)
                regions_of[p] = (fwd[b], regs, multi)
        envs = [(p, i, j) for p, (_, regs, multi) in regions_of.items()
                if not multi for i, j in regs]
        env_out = {}
        if envs:
            M1 = max(self.models[pairs[p][0]].M for p, _, _ in envs) + 1
            Lm = max(j - i + 2 for _, i, j in envs)
            for chunk in _chunks(envs, 3 * Lm * M1 * self.esize,
                                 self.budget):
                sub = [(pairs[p][0], pairs[p][1][i - 1:j]) for p, i, j
                       in chunk]
                bt = self._batch(sub, [len(pairs[p][1]) for p, _, _ in chunk])
                fwd, fsp, frows = dp.forward(bt, "uni", keep_rows=True)
                _, use = dp.backward(bt, "uni", fwd, fsp, frows,
                                     usage=True)
                del frows
                useM = use["M"].double().cpu().numpy()
                useI = use["I"].double().cpu().numpy()
                fwd = fwd.double().cpu().numpy()
                for b, (p, i, j) in enumerate(chunk):
                    h, codes = pairs[p]
                    _, msc = self.prof[h]
                    Ld = j - i + 1
                    m1 = msc.shape[0]
                    uM, uI = useM[b, :m1], useI[b, :m1]
                    xocc = max(Ld - (uM.sum() + uI.sum()), 0.0)
                    with np.errstate(over="ignore"):
                        odds = np.nan_to_num(np.exp(msc), posinf=0.0)
                    null2 = (uM[1:, None] * odds[1:]).sum(axis=0) \
                        + uI.sum() + xocc
                    n2sc = np.log(null2 / Ld)
                    env_out[(p, i, j)] = (fwd[b],
                                          float(n2sc[codes[i - 1:j]].sum()))
        for p, (fwd, regs, multi) in regions_of.items():
            if multi:
                res[p] = (None, None)
                continue
            if not regs:
                res[p] = (None, False)
                continue
            L = len(pairs[p][1])
            n1 = null1(L)
            corr = sum(env_out[(p, i, j)][1] for i, j in regs)
            seqbias = np.logaddexp(0.0, math.log(dp.OMEGA) + corr)
            seq = (fwd - n1 - seqbias) / LN2
            sum_nats, bias_nats, Ld = 0.0, 0.0, 0
            for i, j in regs:
                envsc, dc = env_out[(p, i, j)]
                if envsc - dc > 0.0:
                    sum_nats += envsc
                    Ld += j - i + 1
                    bias_nats += dc
            if Ld > 0:
                sum_nats += (L - Ld) * math.log(L / (L + 3.0))
                bias2 = np.logaddexp(0.0, math.log(dp.OMEGA) + bias_nats)
                sumsc = (sum_nats - n1 - bias2) / LN2
                seq = max(seq, sumsc)
            res[p] = (float(seq), True)
        return res

    # 2-4. weights
    def weights(self, codes_list, num_hmms):
        """Per fragment: ((model, weight), ...) sorted, or None where an
        undecided candidate leaves it open; the pre and reported scores
        [Q, H] (NaN where undecided); and the reported pairs [Q, H]."""
        pre = self.prescores(codes_list)
        H = len(self.idx)
        size = np.array([self.models[h].nseq for h in self.idx], float)
        TOPT = min(H, max(18, num_hmms + 8))
        NEAR = min(H, num_hmms + 4)
        adj = pre + np.log2(size)[None, :]
        cand = []
        for q in range(len(codes_list)):
            top = np.argsort(-adj[q], kind="stable")[:TOPT]
            depth = NEAR if np.all(pre[q, top[:NEAR]] >= 0.0) else TOPT
            cand += [(q, int(j)) for j in top[:depth]]
        rep = self.reported([(self.idx[j], codes_list[q]) for q, j in cand])
        reported = pre - BIAS_FLOOR_BITS
        evaluated = np.zeros(pre.shape, bool)
        gate_ok = np.ones(pre.shape, bool)
        undecided = set()
        for (q, j), (bits, ok) in zip(cand, rep):
            evaluated[q, j] = True
            if ok is None:
                undecided.add(q)
                reported[q, j] = np.nan
                continue
            gate_ok[q, j] = ok
            if bits is not None:
                reported[q, j] = bits
        out = []
        valid_all = np.zeros(pre.shape, bool)
        for q in range(len(codes_list)):
            adj_rep = reported[q] + np.log2(size)
            valid = np.ones(H, bool)
            accepted = 0
            for j in np.argsort(-adj_rep, kind="stable")[:TOPT]:
                if pre[q, j] >= 0.0 or not evaluated[q, j] or gate_ok[q, j]:
                    accepted += 1
                else:
                    valid[j] = False
                if accepted >= num_hmms:
                    break
            valid_all[q] = valid
            if q in undecided:
                out.append(None)
                continue
            sc = np.round(reported[q], 1)
            v = np.flatnonzero(valid)
            order = v[np.argsort(-sc[v], kind="stable")]
            b, s = sc[order], size[order]
            ex = (b[None, :] - b[:, None]) + np.log2(s[None, :] / s[:, None])
            with np.errstate(over="ignore"):
                w = 1.0 / np.power(2.0, ex).sum(axis=1)
            ranked = sorted(zip((self.idx[j] for j in order), w),
                            key=lambda x: x[1], reverse=True)
            out.append(tuple((int(i), float(x)) for i, x in ranked[:num_hmms]))
        return out, pre, reported, valid_all

    # 5. rows
    def columns(self, pairs):
        """hmmalign's match state (0-based) of each residue, -1 for
        inserts and flanks, for (model, codes) pairs."""
        out = []
        M1 = max(self.models[h].M for h, _ in pairs) + 1
        Lm = max(len(c) for _, c in pairs) + 1
        for chunk in _chunks(pairs, 9 * Lm * M1 * self.esize, self.budget):
            bt = self._batch(chunk)
            fwd, fsp, frows = dp.forward(bt, "uni", keep_rows=True)
            post, pp = dp.backward(bt, "uni", fwd, fsp, frows)
            del frows
            mx = dp.oa_fill(bt, pp, post)
            del pp
            for b, (h, codes) in enumerate(chunk):
                L = len(codes)
                m1 = self.models[h].M + 1
                mb = {n: mx[n][b, :L + 1, :m1].double().cpu().numpy()
                      for n in "MID"}
                for n in "NBEJC":
                    mb[n] = mx[n][b, :L + 1].double().cpu().numpy()
                pb = {"C": post["C"][b, :L + 1].double().cpu().numpy()}
                out.append(dp.oa_columns(self.prof[h][0], pb, mb, L))
            del mx
        return out

    def row(self, seq, backbone_length, selection, cols_of):
        """The masked row of a fragment from its (model, weight) selection
        and its columns under each model."""
        per = [(cols_of[h], self.models[h].columns, self.models[h].nongaps,
                w) for h, w in selection]
        return merge_row(seq, backbone_length, per)


def adaptive_top(weights, target=0.999):
    cur, n = 0.0, 0
    while n < len(weights) and cur < target:
        cur += weights[n][1]
        n += 1
    return list(weights[:n])


def find_regions(mocc, ppB, ppE):
    """HMMER's region heuristics (p7_domaindef): [(i, j)] 1-based."""
    L = len(mocc) - 1
    dB = np.zeros(L + 1)
    dB[1:] = ppB[:-1]
    dE = np.zeros(L + 1)
    dE[1:] = ppE[1:]
    out, i2, trig = [], -1, False
    for i in range(1, L + 1):
        if not trig:
            if mocc[i] - dB[i] < RT2:
                i2 = i
            elif i2 == -1:
                i2 = i
            if mocc[i] >= RT1:
                trig = True
        elif mocc[i] - dE[i] < RT2:
            out.append((max(i2, 1), i))
            i2, trig = -1, False
    if trig:
        out.append((max(i2, 1), L))
    return out


def split_mass(btot, etot, i, j):
    """max over z in [i, j] of min(E mass in [i, z], B mass in [z, j])."""
    ps = np.arange(i, j + 1)
    epre = etot[ps] - etot[i - 1]
    bpost = btot[j] - btot[ps - 1]
    return float(np.minimum(epre, bpost).max()) if j >= i else 0.0


def merge_row(seq, backbone_length, per_model):
    """witch-ng's merge of one fragment into the backbone's columns; the
    masked row (residues on backbone columns, '-' elsewhere), or '' when
    no residue lands on a column."""
    n = len(seq)
    lo, hi, trip = backbone_length + 1, -1, []
    for cols, columns, nongaps, w in per_model:
        r = np.flatnonzero(cols >= 0)
        if not len(r):
            continue
        c = columns[cols[r]]
        trip.append((r, c, nongaps[cols[r]].astype(np.float64) * w))
        lo, hi = min(lo, int(c.min())), max(hi, int(c.max()))
    if not trip:
        return ""
    band = hi - lo + 1
    cw = np.zeros((n, band))
    for r, c, w in trip:
        np.add.at(cw, (r, c - lo), w)
    bt = np.zeros((n + 1, band + 1), np.int8)
    prev = np.zeros(band + 1)
    for i in range(1, n + 1):
        w = cw[i - 1]
        d = prev[:-1] + w
        up = prev[1:]
        has = w > 0
        c = np.where(has, np.maximum(d, up), up)
        row = np.maximum.accumulate(np.concatenate(([0.0], c)))
        left = row[:-1]
        bt[i, 1:] = np.where(left > c, 2, np.where(has & (d >= up), 0, 1))
        prev = row
    out, i, t = [], n, band
    while i > 0 and t > 0:
        b = bt[i, t]
        if b == 0:
            out.append(seq[i - 1])
            i, t = i - 1, t - 1
        elif b == 1:
            out.append(seq[i - 1].lower())
            i -= 1
        else:
            out.append("-")
            t -= 1
    out += [seq[k].lower() for k in range(i - 1, -1, -1)]
    out += ["-"] * t
    full = "-" * lo + "".join(reversed(out)) + "-" * (backbone_length - hi - 1)
    return re.sub("[a-z]", "", full)
