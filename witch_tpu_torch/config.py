"""Configuration system: cmdline > user config (-c) > main config.

Mirrors the reference's layered precedence (witch_msa/configs.py:240-264):
a config file's [commandline] section becomes synthetic argv prepended
before the real argv; other sections become namespaces on Configs. The
reference's ~/.witch_msa bootstrap dealt with locating tool binaries —
obsolete here (no external binaries), so main config is optional at
~/.witch_tpu/main.config.
"""

from __future__ import annotations

import configparser
import os
import time
from argparse import Namespace
from typing import List, Optional


class Configs:
    # paths
    input_path: Optional[str] = None
    hmmdir: Optional[str] = None
    backbone_path: Optional[str] = None
    backbone_tree_path: Optional[str] = None
    query_path: Optional[str] = None
    outdir: str = "witch_output"
    output_path: str = "aligned.fasta"

    keeptemp: bool = False
    keep_decomposition: bool = True
    full_search_results: bool = False

    # WITCH options
    mode: str = "witch-ng"
    num_hmms: int = 10
    use_weight: bool = True
    save_weight: bool = False
    alignment_size: int = 10
    alignment_upper_bound: Optional[int] = None
    molecule: Optional[str] = None
    timeout: int = 120

    num_cpus: int = -1
    max_concurrent_jobs: Optional[int] = None
    chunksize: int = 1
    collapse_singletons: bool = True
    subset_size: int = 1
    weight_adjust: str = "none"

    # backbone construction (only used without -b); mirrors the
    # reference's [Backbone] config section (witch_msa/configs.py:139-166)
    backbone_size: Optional[int] = None
    selection_strategy: Optional[str] = None
    backbone_method: Optional[str] = None

    # GCM / old-witch merge options (reference configs.py:86-89)
    keepgcmtemp: bool = False
    inflation_factor: float = 4.0
    graphclustermethod: str = "mcl"
    graphtracemethod: str = "minclusters"
    graphtraceoptimize: str = "false"

    # the cards the latest pipeline run scores on (pipeline.py sets it;
    # a server's .done records it)
    scoring_cards: Optional[List[str]] = None

    # log paths
    log_path: Optional[str] = None
    error_path: Optional[str] = None
    debug_path: Optional[str] = None
    runtime_path: Optional[str] = None

    @staticmethod
    def write(msg, level, path):
        if path is not None:
            with open(path, "a") as f:
                f.write("{}\t[{}] {}\n".format(
                    time.strftime("%Y-%m-%d %H:%M:%S"), level, msg))

    @staticmethod
    def log(msg):
        Configs.write(msg, "LOG", Configs.log_path)

    @staticmethod
    def warning(msg):
        Configs.write(msg, "WARNING", Configs.log_path)

    @staticmethod
    def debug(msg):
        Configs.write(msg, "DEBUG", Configs.debug_path)

    @staticmethod
    def error(msg):
        Configs.write(msg, "ERROR", Configs.error_path)

    @staticmethod
    def runtime(msg):
        if Configs.runtime_path:
            with open(Configs.runtime_path, "a") as f:
                f.write("{}\n".format(msg))


def _config_file_to_argv(path: str) -> List[str]:
    cp = _read_config(path)
    argv = []
    if cp.has_section("commandline"):
        for k, v in cp.items("commandline"):
            argv.append("--{}".format(k))
            argv.append(v)
    return argv


def _read_config(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser()
    cp.optionxform = str
    with open(path) as f:
        cp.read_file(f)
    return cp


def set_valid_configuration(name: str, section: dict) -> None:
    """Validate + apply a non-[commandline] config section (the
    reference's set_valid_configuration, witch_msa/configs.py:134-184).

    [Backbone] -> backbone construction knobs (typed/choice-checked),
    also exposed as the Configs.Backbone namespace;
    [Basic]    -> integer-checked overrides of Configs class attrs;
    [MAGUS]    -> stored as the Configs.MAGUS namespace (GCM knobs with
    matching names are applied to Configs).
    """
    ns = Namespace(**section)
    if name == "Backbone":
        for k, v in section.items():
            if not v:
                continue
            if k == "alignment_method":
                assert str(v).lower() in ("magus", "pasta", "mafft"), \
                    "Backbone alignment method %s not implemented" % v
                Configs.backbone_method = str(v).lower()
            elif k == "backbone_size":
                try:
                    Configs.backbone_size = int(str(v).strip())
                except ValueError:
                    Configs.warning("backbone_size must be an integer, "
                                    "got %s. Using default" % v)
            elif k == "selection_strategy":
                assert str(v).lower() in ("median_length", "random"), \
                    "Selection strategy %s not implemented" % v
                Configs.selection_strategy = str(v).lower()
        setattr(Configs, name, ns)
    elif name == "Basic":
        for k, v in section.items():
            if not v:
                continue
            if k in ("alignment_size", "num_hmms", "chunksize",
                     "num_cpus"):
                try:
                    v = int(str(v).strip())
                except ValueError:
                    Configs.warning("%s must be an integer, got %s. "
                                    "Using default" % (k, v))
                    continue
            setattr(Configs, k, v)
    elif name == "MAGUS":
        for k, v in section.items():
            if not v:
                continue
            if k == "inflation_factor":
                try:
                    Configs.inflation_factor = float(str(v).strip())
                except ValueError:
                    Configs.warning("inflation_factor must be a float, "
                                    "got %s. Using default" % v)
            elif k in ("graphclustermethod", "graphtracemethod",
                       "graphtraceoptimize"):
                setattr(Configs, k, str(v).strip())
        setattr(Configs, name, ns)


_section_set_attrs: set = set()


def _apply_config_sections(path: str) -> None:
    before = {k: getattr(Configs, k) for k in vars(Configs)
              if not k.startswith("_") and not callable(getattr(Configs, k))}
    cp = _read_config(path)
    for section in cp.sections():
        if section == "commandline":
            continue
        set_valid_configuration(section, dict(cp.items(section)))
    for k, v in before.items():
        if getattr(Configs, k, v) is not v:
            _section_set_attrs.add(k)


def main_config_path() -> Optional[str]:
    p = os.path.join(os.path.expanduser("~"), ".witch_tpu", "main.config")
    return p if os.path.exists(p) else None


def build_configs(parser, cmdline_args: List[str]) -> Namespace:
    """Parse with layered precedence and populate Configs."""
    default_argv: List[str] = []
    mc = main_config_path()
    if mc:
        default_argv += _config_file_to_argv(mc)
    args = parser.parse_args(cmdline_args)
    user_argv: List[str] = []
    if getattr(args, "config_file", None):
        user_argv += _config_file_to_argv(args.config_file)
    args = parser.parse_args(default_argv + user_argv + cmdline_args)

    # non-[commandline] sections (main config first, then user config so
    # the user file wins; explicitly-passed cmdline flags win over both)
    _section_set_attrs.clear()
    if mc:
        _apply_config_sections(mc)
    if getattr(args, "config_file", None):
        _apply_config_sections(args.config_file)

    def _explicit(attr):
        """cmdline value should apply: either the flag was explicitly
        given (differs from the parser default) or no config section
        set the attribute."""
        return (getattr(args, attr) != parser.get_default(attr)
                or attr not in _section_set_attrs)

    for name in ("input_path", "hmmdir", "backbone_path",
                 "backbone_tree_path", "query_path"):
        v = getattr(args, name, None)
        # always assign (None resets state from any previous invocation
        # in the same process)
        setattr(Configs, name,
                os.path.realpath(v) if v is not None else None)

    Configs.outdir = os.path.realpath(args.outdir)
    os.makedirs(Configs.outdir, exist_ok=True)
    Configs.output_path = os.path.join(Configs.outdir, args.output_path)

    Configs.keeptemp = bool(args.keeptemp)
    Configs.keep_decomposition = args.keep_decomposition == 1
    Configs.full_search_results = \
        getattr(args, "full_search_results", 0) == 1
    if _explicit("mode"):
        Configs.mode = args.mode
    if _explicit("num_hmms") and args.num_hmms > 0:
        Configs.num_hmms = args.num_hmms
    Configs.use_weight = args.use_weight == 1
    Configs.save_weight = args.save_weight == 1
    if _explicit("alignment_size"):
        Configs.alignment_size = args.alignment_size
    if _explicit("molecule"):
        Configs.molecule = args.molecule
    if _explicit("timeout"):
        Configs.timeout = args.timeout
    if _explicit("num_cpus"):
        Configs.num_cpus = (args.num_cpus if args.num_cpus > 0
                            else os.cpu_count())
    Configs.max_concurrent_jobs = (args.max_concurrent_jobs or
                                   min(50, 10 * Configs.num_cpus))
    if _explicit("chunksize"):
        Configs.chunksize = max(1, args.chunksize)
    Configs.collapse_singletons = args.collapse_singletons == 1
    Configs.subset_size = max(1, args.subset_size)
    if _explicit("weight_adjust"):
        Configs.weight_adjust = args.weight_adjust
    # backbone/GCM knobs: cmdline > config section > default (also
    # resetting any state left by a previous build_configs call)
    for attr in ("backbone_size", "selection_strategy",
                 "backbone_method", "alignment_upper_bound",
                 "inflation_factor", "graphclustermethod",
                 "graphtracemethod", "graphtraceoptimize"):
        v = getattr(args, attr)
        if _explicit(attr):
            setattr(Configs, attr, v)
    Configs.keepgcmtemp = bool(args.keepgcmtemp)
    if Configs.alignment_upper_bound is not None and \
            int(Configs.alignment_upper_bound) <= 0:
        Configs.alignment_upper_bound = None

    Configs.log_path = os.path.join(Configs.outdir, "log.txt")
    Configs.error_path = os.path.join(Configs.outdir, "error.txt")
    Configs.debug_path = os.path.join(Configs.outdir, "debug.txt")
    Configs.runtime_path = os.path.join(Configs.outdir,
                                        "runtime_breakdown.txt")
    return args
