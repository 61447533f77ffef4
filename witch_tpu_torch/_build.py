"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel source (csrc/*.cu) compiles for sm_90a in its own nvcc
process, all started together, and one more nvcc call links the objects
into a shared library with a plain C interface under
build/witch_tpu_torch/ (named by a hash of the sources, so an edited
source rebuilds). Each C entry launches on the caller's stream and
returns cudaGetLastError(); the wrappers raise on any nonzero code.

Nothing here runs at import: nvcc and ctypes are reached only through
lib(), which the kernel wrappers call when given CUDA tensors.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
SOURCES = ("forward.cu", "null2.cu", "oa.cu", "flank.cu", "pairhmm.cu",
           "cluster.cu", "overlay.cu", "effn.cu")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "witch_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

# Dynamic shared memory a kernel's working rows may take: sm_90's 227 KB
# per block less room for the kernels' static shared scratch. Wider rows
# go to a device buffer (the wrappers pick the layout per launch).
SMEM_ROWS_MAX = 232448 - 1024

# Kernel launches per wrapper since the last reset (plain integers: the
# wrappers add one where they launch their kernel, and nowhere else).
LAUNCHES = {"forward": 0, "null2": 0, "oa": 0, "flank": 0, "pairhmm": 0,
            "overlay": 0, "effn": 0}
# CUDA-event milliseconds of each kernel's launches since the last reset
# (ops/forward.py adds a launch's at its collect; ops/null2.py, ops/oa.py,
# ops/flank.py, ops/pairhmm.py, ops/overlay.py and ops/effn.py add each
# call's launches, from the first to the last, once the last has finished)
KERNEL_MS = {"forward": 0.0, "null2": 0.0, "oa": 0.0, "flank": 0.0,
             "pairhmm": 0.0, "overlay": 0.0, "effn": 0.0}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in KERNEL_MS:
        KERNEL_MS[k] = 0.0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from witch_tpu_torch/csrc at "
                       "first use")


def _source_hash() -> str:
    h = hashlib.blake2b(digest_size=8)
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _run_all(cmds):
    """Run the commands concurrently; raise with nvcc's output on the
    first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append("nvcc failed (rc=%d): %s\n%s"
                          % (p.returncode, " ".join(cmd), out[-4000:]))
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> str:
    """Compile csrc/*.cu into the shared library (if not built yet);
    returns its path. Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, "libwitch_kernels_%s.so" % _source_hash())
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    tag = "%d" % os.getpid()
    objs = [os.path.join(BUILD_DIR, "%s.%s.o" % (s, tag)) for s in SOURCES]
    _run_all([[nvcc] + NVCC_FLAGS + ["-c", "-o", o, os.path.join(CSRC, s)]
              for s, o in zip(SOURCES, objs)])
    tmp = out + ".%s.tmp" % tag
    _run_all([[nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp] + objs])
    for o in objs:
        os.remove(o)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            import ctypes
            path = build()
            so = ctypes.CDLL(path)
            P, I = ctypes.c_void_p, ctypes.c_int
            so.witch_forward_nats.argtypes = [P] * 6 + [I] * 8 + [P]
            so.witch_null2.argtypes = [P] * 13 + [I] * 6 + [P]
            so.witch_null2_ctas_per_sm.argtypes = [I] * 4 + [P]
            so.witch_oa.argtypes = [P] * 16 + [I, I, I, I, P]
            so.witch_oa_warp.argtypes = [P] * 17 + [I] * 6 + [P]
            so.witch_oa_cluster.argtypes = [P] * 17 + [I] * 6 + [P]
            so.witch_oa_cluster_active.argtypes = [I, I]
            so.witch_flank.argtypes = [P] * 9 + [I] * 6 + [P]
            so.witch_flank_warp.argtypes = [P] * 11 + [I] * 8 + [P]
            so.witch_flank_cluster.argtypes = [P] * 11 + [I] * 8 + [P]
            so.witch_flank_cluster_active.argtypes = [I, I]
            so.witch_pairhmm.argtypes = [P] * 7 + [I] * 5 + \
                [ctypes.c_float] * 4 + [P]
            so.witch_pairhmm_reg.argtypes = [P] * 6 + [I] * 5 + \
                [ctypes.c_float] * 4 + [P]
            so.witch_pairhmm_wide.argtypes = [P] * 6 + [I] * 6 + \
                [ctypes.c_float] * 4 + [P]
            so.witch_pairhmm_wide_ctas_per_sm.argtypes = [I] * 3 + [P]
            so.witch_cluster_probe.argtypes = [I] * 4 + [P] * 3
            so.witch_cluster_probe_active.argtypes = [I]
            so.witch_overlay.argtypes = [P] * 18 + [I] * 4 + [P]
            so.witch_effn.argtypes = [P] * 8 + [I] * 3 + [P]
            for fn in (so.witch_cluster_probe, so.witch_cluster_probe_active,
                       so.witch_forward_nats, so.witch_null2, so.witch_oa,
                       so.witch_oa_warp, so.witch_oa_cluster,
                       so.witch_oa_cluster_active, so.witch_flank,
                       so.witch_flank_warp, so.witch_flank_cluster,
                       so.witch_flank_cluster_active,
                       so.witch_null2_ctas_per_sm, so.witch_pairhmm,
                       so.witch_pairhmm_reg, so.witch_pairhmm_wide,
                       so.witch_pairhmm_wide_ctas_per_sm, so.witch_overlay,
                       so.witch_effn):
                fn.restype = I
            _lib = so
        return _lib


def check(rc: int, name: str, count: bool = True, device=None) -> None:
    """Raise if a C entry reported a CUDA error, naming the card it ran on
    (`device`, else the current card); count the launch (unless the entry
    launched nothing)."""
    if rc != 0:
        import torch
        if torch.cuda.is_available():
            idx = None if device is None else torch.device(device).index
            if idx is None:
                idx = torch.cuda.current_device()
            where = "cuda:%d, %s" % (idx, torch.cuda.get_device_name(idx))
        else:
            where = "no device"
        raise RuntimeError("CUDA kernel %s failed to launch: error %d (%s)"
                           % (name, rc, where))
    if count:
        LAUNCHES[name] += 1


def stream_ptr(device) -> int:
    """The current stream of `device`'s card (torch.cuda.current_stream:
    the stream PyTorch's own work on that card takes from this thread).
    The C entries also set kernel attributes on the current card, so a
    launch through this stream runs with `device` current (on_card)."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def on_card(device):
    """A context in which `device`'s card is the current CUDA device; no
    context for a CPU device."""
    import contextlib
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
