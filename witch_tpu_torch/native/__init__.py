"""The port's native host engine (C++, CPython C API): _domaindef (domain
definition, the exact f64 and f32 Forward, flank rows, posterior + OA),
_oa (OA and merge DPs) and _pairhmm (the scenario-A backbone aligner's
pair HMM). The sources are copies of witch_tpu/native/*.cpp.

They are built at first use (the first access to one of them, as in
`from witch_tpu_torch.native import _domaindef`; importing this package
builds nothing), one C++ compiler process per extension, all started
together, with the flags witch_tpu's setup.py gives them
(-ffp-contract=off for _domaindef: its exact-f32 chain reproduces the
reference binary's separate multiply and add roundings), into
build/witch_tpu_torch/native/<key>/. The key hashes the sources, the
flags, the compiler, Python's extension suffix, numpy's version and the
host CPU's feature flags (-march=native), so a checkout carried to
another host rebuilds. Concurrent processes (pytest-xdist workers)
serialise the build through a file lock. A failed build raises with the
compiler's output: nothing falls back to numpy.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shlex
import subprocess
import sys
import sysconfig
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "witch_tpu_torch", "native")
_BASE = ["-O3", "-std=c++17", "-march=native", "-funroll-loops"]
EXTENSIONS = {
    "_oa": ("oa_kernel.cpp", _BASE),
    "_pairhmm": ("pairhmm_kernel.cpp", _BASE),
    "_domaindef": ("domaindef_kernel.cpp", _BASE + ["-ffp-contract=off"]),
}
HEADERS = ("stoch_f32.h",)
_load_lock = threading.Lock()


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    import platform
    return platform.processor() or platform.machine()


def _compiler():
    cxx = shlex.split(sysconfig.get_config_var("CXX") or "g++")
    cflags = shlex.split(sysconfig.get_config_var("CFLAGS") or "")
    ccshared = shlex.split(sysconfig.get_config_var("CCSHARED") or "-fPIC")
    return cxx, cflags + ccshared


def _includes():
    import numpy
    return ["-I" + sysconfig.get_paths()["include"],
            "-I" + numpy.get_include()]


def build_key() -> str:
    import numpy
    cxx, flags = _compiler()
    try:
        ver = subprocess.run(cxx + ["--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except OSError as e:
        raise RuntimeError("witch_tpu_torch.native: no C++ compiler (%s): "
                           "the native engine is built at first use" % e)
    h = hashlib.blake2b(digest_size=8)
    for src in sorted({s for s, _ in EXTENSIONS.values()} | set(HEADERS)):
        with open(os.path.join(_HERE, src), "rb") as f:
            h.update(src.encode() + f.read())
    for name in sorted(EXTENSIONS):
        h.update((name + " ".join(EXTENSIONS[name][1])).encode())
    for part in (" ".join(cxx + flags), ver,
                 sysconfig.get_config_var("EXT_SUFFIX") or "",
                 numpy.__version__, _cpu_flags()):
        h.update(part.encode())
    return h.hexdigest()


def _built(out_dir: str) -> bool:
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    return all(os.path.exists(os.path.join(out_dir, name + suffix))
               for name in EXTENSIONS)


def build() -> str:
    """Compile the three extensions (if not built yet for this key);
    returns their directory. Raises with the compiler's output."""
    out_dir = os.path.join(BUILD_ROOT, build_key())
    if _built(out_dir):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    import fcntl
    with open(os.path.join(out_dir, ".lock"), "a+") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _built(out_dir):
                _compile_all(out_dir)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)
    return out_dir


def _compile_all(out_dir: str) -> None:
    cxx, flags = _compiler()
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    tag = ".%d.tmp" % os.getpid()
    procs = []
    for name, (src, extra) in sorted(EXTENSIONS.items()):
        out = os.path.join(out_dir, name + suffix)
        cmd = cxx + flags + _includes() + extra + [
            "-shared", os.path.join(_HERE, src), "-o", out + tag]
        procs.append((cmd, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, out, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append("C++ build failed (rc=%d): %s\n%s"
                          % (p.returncode, " ".join(cmd), log[-4000:]))
    if failed:
        raise RuntimeError("witch_tpu_torch.native: " + "\n".join(failed))
    for _, out, _ in procs:
        os.replace(out + tag, out)


def __getattr__(name: str):
    """_oa, _pairhmm, _domaindef: built and loaded at first access."""
    if name not in EXTENSIONS:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    full = __name__ + "." + name
    with _load_lock:
        if full not in sys.modules:
            out_dir = build()
            suffix = sysconfig.get_config_var("EXT_SUFFIX")
            for ext in EXTENSIONS:
                path = os.path.join(out_dir, ext + suffix)
                loader = importlib.machinery.ExtensionFileLoader(
                    __name__ + "." + ext, path)
                spec = importlib.util.spec_from_file_location(
                    loader.name, path, loader=loader)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                sys.modules.setdefault(loader.name, mod)
    mod = sys.modules[full]
    if mod is None:           # blocked, as the import system treats None
        raise ImportError("import of %s halted; None in sys.modules" % full)
    return mod


_trace_alphabet = None


def set_trace_alphabet(molecule: str) -> bool:
    """Enable _domaindef's exact-f32 stochastic-trace path by handing it
    this molecule's degeneracy/background tables (idempotent; returns
    False when disabled via WITCH_TPU_F32TRACE=0)."""
    global _trace_alphabet
    if _trace_alphabet == molecule:
        return True
    try:
        import numpy as np

        from ..core.alphabet import ALPHABETS
        from ..hmm.priors import get_background
        from . import _domaindef
        alpha = ALPHABETS[molecule]
        expand = np.ascontiguousarray(alpha._expand, np.float64)
        bg = np.ascontiguousarray(get_background(molecule), np.float64)
        ok = bool(_domaindef.set_alphabet(expand, bg))
        if ok:
            _trace_alphabet = molecule
            # best-effort exact-libm upgrade (WITCH_TPU_ICC_LIBM names
            # the reference hmmsearch binary)
            try:
                from . import icc_libm
                icc_libm.install(_domaindef)
            except Exception:
                pass
        return ok
    except Exception:
        return False
