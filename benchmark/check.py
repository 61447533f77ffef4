"""The comparison that decides `correct`.

While the window runs, each job's outputs are read as it ends: every
fragment has to be in the merged output or in ignored_queries.fasta
(`missing` counts those that are in neither, and every fragment of a job
that raised), and for a seeded draw of the
job's fragments (the traffic's check_candidates_per_job, in the drawn
order) the harness keeps what the job produced for them: the masked row,
the weights (weights.txt) and, where the job persisted them, the search
results. The first job of the window keeps its decomposition directory
(a -p cell's is the one set-up built).

After the window, the plain reference (reference/) works everything out
again from the benchmark's own inputs, the backbone, the tree and the
fragments, and compare.py holds the program's outputs against it: the
candidates are taken one from each job in turn until check_decided of
them have weights that the reference decides.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from . import compare


class Checker:
    def __init__(self, cell, seed):
        self.cell = cell
        self.seed = int(seed)
        self.missing = 0
        self.candidates = []     # per job: (job k, name, fragment, row,
        #                          weights, scores) in the drawn order
        self.ens_dir = None
        self.per_job = int(cell.traffic["check_candidates_per_job"])

    def collect(self, k, job, outdir, names, frags):
        """Read job k's outputs (before its directory is deleted); the
        fragments of a job that raised never come."""
        if not job.ok:
            self.missing += job.n
            return
        masked = os.path.join(outdir, "aligned.masked.fasta")
        rows = _read_fasta(masked) if os.path.exists(masked) else {}
        ign_path = os.path.join(outdir, "ignored_queries.fasta")
        ignored = set(_read_fasta(ign_path)) if os.path.exists(ign_path) \
            else set()
        self.missing += sum(1 for n in names
                            if n not in rows and n not in ignored)
        pick = self.pick(k, len(names))
        want = {names[i] for i in pick}
        weights = _read_weights(os.path.join(outdir, "weights.txt"), want)
        hmmdir = self.cell.hmmdir or os.path.join(outdir, "tree_decomp",
                                                  "root")
        scores = _read_results(hmmdir, want) \
            if self.cell.hmmdir is None else {}
        self.candidates.append([(k, names[i], frags[i], rows.get(names[i]),
                                 weights.get(names[i]),
                                 scores.get(names[i], {})) for i in pick])
        if self.ens_dir is None:
            if self.cell.hmmdir is not None:
                self.ens_dir = self.cell.hmmdir
            elif os.path.isdir(hmmdir):
                self.ens_dir = os.path.join(self.cell.workdir, "ensemble_job")
                shutil.move(hmmdir, self.ens_dir)

    def pick(self, k, n):
        """Indices of job k's candidate fragments, in the order drawn from
        the seed."""
        rng = np.random.default_rng([self.seed, 7, k])
        return rng.choice(n, min(self.per_job, n), replace=False).tolist()

    def samples(self):
        """Every job's candidates, one from each job in turn."""
        return interleave(self.candidates)

    def verify(self):
        """(correct, {name: {"value", "limit"}})."""
        return compare.verify(self.cell, self.ens_dir, self.samples(),
                              self.missing)


def interleave(lists):
    """The first of each list, then the second of each, and so on."""
    out = []
    for r in range(max((len(l) for l in lists), default=0)):
        out += [l[r] for l in lists if r < len(l)]
    return out


def _read_fasta(path):
    out, name, buf = {}, None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(buf)
                name, buf = line[1:].split()[0], []
            else:
                buf.append(line)
    if name is not None:
        out[name] = "".join(buf)
    return out


def _read_weights(path, want):
    """{fragment: ((hmm index, weight), ...)} of the wanted fragments."""
    import ast
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            name, _, raw = line.partition(":")
            if name in want:
                out[name] = tuple((int(i), float(w))
                                  for i, w in ast.literal_eval(raw.strip()))
    return out


def _read_results(hmmdir, want):
    """{fragment: {hmm index: bits}} of the wanted fragments, from the
    persisted hmmsearch.results.A_0_<i>.* files (python dict literals
    {taxon: (evalue, bits)})."""
    import re
    out = {}
    if not os.path.isdir(hmmdir):
        return out
    pat = re.compile(r"'(%s)': \(([^,]+), ([^)]+)\)"
                     % "|".join(re.escape(n) for n in sorted(want)))
    for d in os.listdir(hmmdir):
        m = re.match(r"A_0_(\d+)$", d)
        if not m:
            continue
        sub = os.path.join(hmmdir, d)
        for fn in os.listdir(sub):
            if fn.startswith("hmmsearch.results."):
                with open(os.path.join(sub, fn)) as f:
                    text = f.read()
                for name, _, bits in pat.findall(text):
                    out.setdefault(name, {})[int(m.group(1))] = float(bits)
    return out
