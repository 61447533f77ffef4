"""CLI argument parser, mirroring the reference's flag surface
(witch_msa/__init__.py:32-233) so existing WITCH invocations port directly.
"""

from __future__ import annotations

from argparse import ArgumentParser, RawDescriptionHelpFormatter

from . import __version__

EXAMPLES = """Example usages:
> Default usage - unaligned input sequences
  %(prog)s -i input.fasta -d witch_output/ -o alignment.fasta

> Adding new sequences to an existing backbone alignment (no tree)
  %(prog)s -q new_seqs.fasta -b existing_aln.fasta

> Adding new sequences to an existing backbone alignment (with tree)
  %(prog)s -q new_seqs.fasta -b existing_aln.fasta -e existing_aln.nwk

> Using 5 HMMs to align non-backbone sequences, HMMs of 50-100 sequences
  %(prog)s -i input.fasta -k 5 -A 50 -Z 100
"""


def init_parser() -> ArgumentParser:
    parser = ArgumentParser(
        description=("WITCH-TPU: a TPU-native re-implementation of WITCH "
                     "(WeIghTed Consensus Hmm alignment)."),
        conflict_handler="resolve",
        epilog=EXAMPLES,
        formatter_class=RawDescriptionHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s " + __version__)

    basic = parser.add_argument_group("BASIC PARAMETERS")
    basic.add_argument("-i", "--input-path", type=str,
                       help="Path to the input unaligned file "
                            "(all sequences).")
    basic.add_argument("-p", "--hmmdir", type=str,
                       help="Path to the HMMs directory generated from a "
                            "previous (UPP/WITCH/witch-tpu) decomposition")
    basic.add_argument("-b", "--backbone-path", type=str,
                       help="Path to the backbone alignment")
    basic.add_argument("-e", "--backbone-tree-path", type=str,
                       help="Path to the backbone tree")
    basic.add_argument("-q", "--query-path", type=str,
                       help="Path to the queries file to align")
    basic.add_argument("-d", "--outdir", type=str, default="witch_output",
                       help="Output directory. Default: witch_output/")
    basic.add_argument("-o", "--output-path", type=str,
                       default="aligned.fasta",
                       help="Output file name (a <name>.masked.fasta "
                            "is also written). Default: aligned.fasta")
    basic.add_argument("-t", "--num-cpus", type=int, default=-1,
                       help="Number of cpus for host-side parallelism. "
                            "Default: -1 (all)")
    basic.add_argument("--max-concurrent-jobs", type=int, default=None,
                       metavar="INT",
                       help="Max concurrently running host jobs. "
                            "Default: min(50, 10*num_cpus)")
    basic.add_argument("--timeout", type=int, default=120, metavar="INT",
                       help="Per-query alignment timeout seconds "
                            "(compat flag). Default: 120")
    basic.add_argument("-c", "--config-file", type=str, default=None,
                       help="User config file (cmdline > user > main)")
    basic.add_argument("--chunksize", type=int, default=1,
                       help="Batching multiplier for device dispatch "
                            "chunks (scoring/posterior/null2 batches "
                            "scale with it). Default: 1")
    basic.add_argument("--collapse-singletons", type=int, default=1,
                       metavar="{0,1}",
                       help="Collapse insertion columns from different "
                            "queries at the same backbone boundary into "
                            "shared (lowercase) columns. 0 keeps every "
                            "query's insertions in private columns. "
                            "Default: 1")

    bb = parser.add_argument_group(
        "BACKBONE OPTIONS",
        "These options control how backbone sequences are selected "
        "and aligned (only used without -b).")
    bb.add_argument("--backbone-size", type=int, default=None,
                    help="Number of sequences in the backbone. "
                         "Default: min(1000, len(all_taxa))")
    bb.add_argument("--selection-strategy", type=str, default=None,
                    choices=["median_length", "random"],
                    help="Backbone sequence selection strategy. Default: "
                         "sequences with lengths 25%% around the median")
    bb.add_argument("--backbone-method", type=str, default=None,
                    choices=["magus", "pasta", "mafft"],
                    help="Backbone alignment method; all choices map to "
                         "the built-in probabilistic-consistency aligner: "
                         "pasta = two-pass PASTA-style iteration (default; "
                         "best measured quality), magus/mafft = single "
                         "pass (faster on small backbones)")

    witch = parser.add_argument_group("WITCH OPTIONS")
    witch.add_argument("-m", "--mode", type=str, default="witch-ng",
                       choices=["old-witch", "witch-ng"],
                       help="Query-merge mode. Default: witch-ng")
    witch.add_argument("--keeptemp", action="store_const", const=True,
                       default=False, help="Keep ALL temporary files")
    witch.add_argument("--keep-decomposition", type=int, default=1,
                       metavar="{0,1}",
                       help="Keep tree decomposition artifacts. Default: 1")
    witch.add_argument("--full-search-results", type=int, default=0,
                       metavar="{0,1}",
                       help="witch-tpu extension: evaluate the reporting "
                            "gate and exact scores for EVERY (query, HMM) "
                            "pair so the persisted hmmsearch.results.* "
                            "files list the complete reported set, as the "
                            "reference's hmmsearch runs would (several "
                            "minutes of host compute on large grids). "
                            "Default: 0 (evaluate only the pairs that can "
                            "affect weights)")
    witch.add_argument("-k", "--num-hmms", type=int, default=10,
                       help="Max top-scored HMMs per query (adaptive "
                            "inclusion to weight 0.999). Default: 10")
    witch.add_argument("-w", "--use-weight", type=int, default=1,
                       metavar="{0,1}",
                       help="Use adjusted bitscore weights. Default: 1")
    witch.add_argument("--save-weight", type=int, default=0,
                       metavar="{0,1}",
                       help="Save weights to [outdir]/weights.txt. "
                            "Default: 0")
    witch.add_argument("-A", "--alignment-size", type=int, default=10,
                       help="Min decomposition subset size. Default: 10")
    witch.add_argument("-Z", "--alignment-upper-bound", type=int,
                       default=None,
                       help="Max decomposition subset size. Default: None")
    witch.add_argument("--molecule", type=str, default=None,
                       choices=["amino", "dna", "rna"],
                       help="Input molecule type. Default: infer")
    witch.add_argument("-s", "--subset-size", type=int, default=1,
                       help="Number of queries per GCM merge batch in "
                            "old-witch mode (batched queries share one "
                            "MCL clustering). Default: 1")
    witch.add_argument("--weight-adjust", type=str, default="none",
                       choices=["none", "normalize", "maxto1"],
                       help="(DEPRECATED upstream) Optional adjustment "
                            "of the per-query weight vector. Default: none")

    misc = parser.add_argument_group("MISCELLANEOUS OPTIONS")
    misc.add_argument("-y", "--bypass-setup", action="store_const",
                      const=True, default=True,
                      help="(compat) bypass initial setup")

    gcm = parser.add_argument_group(
        "MAGUS/GCM OPTIONS",
        "These options customize the GCM merge used by old-witch mode.")
    gcm.add_argument("--keepgcmtemp", action="store_const", const=True,
                     default=False,
                     help="Keep temporary GCM artifacts")
    gcm.add_argument("-f", "--inflation-factor", type=float, default=4.0,
                     help="Inflation factor for MCL. Default: 4")
    gcm.add_argument("--graphclustermethod", type=str, default="mcl",
                     choices=["mcl", "mlrmcl", "rg", "none"],
                     help="Initial clustering of the alignment graph "
                          "(mlrmcl/rg fall back to mcl). Default: mcl")
    gcm.add_argument("--graphtracemethod", type=str, default="minclusters",
                     choices=["minclusters", "mwtgreedy", "mwtsearch",
                              "fm", "rg", "rgfast"],
                     help="Trace method; with two constraint alignments "
                          "every choice reduces to the same exact banded "
                          "DP. Default: minclusters")
    gcm.add_argument("--graphtraceoptimize", type=str, default="false",
                     choices=["true", "false"],
                     help="Optimization pass on the trace (identity here: "
                          "the 2-constraint trace is already optimal). "
                          "Default: false")
    return parser
