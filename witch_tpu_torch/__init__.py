"""witch_tpu_torch: the PyTorch/CUDA port of witch_tpu (WITCH,
weighted consensus HMM alignment) for one NVIDIA H100.

The device stages run in hand-written CUDA kernels (csrc/). The host
stages (decomposition, hmmbuild, native domain definition, weighting,
merge, tree search, backbone alignment) are the port's own copies of
witch_tpu's host modules, under the same relative names, with the
native C++ engine built from native/ at first use. The port imports
nothing of witch_tpu and nothing of JAX."""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device", "witch_runner"]


def witch_runner(argv=None):
    """CLI entry: the reference's witch.py flags (cli.py). Runs on CUDA
    and raises without it; scores over every visible card unless
    WITCH_TPU_NO_MESH is set (parallel/mesh.py). When a live server
    (server.py) on a CUDA device already watches
    server.default_jobs_dir(), the run is submitted to it instead;
    WITCH_TPU_NO_DAEMON=1 keeps it in this process. The CLI never starts
    a server."""
    import os
    import sys
    import time

    cmdline_args = sys.argv[1:] if argv is None else argv
    if not os.environ.get("WITCH_TPU_NO_DAEMON") \
            and not os.environ.get("WITCH_TPU_IN_SERVER"):
        from . import server
        s1 = time.time()
        res = server.run_via_daemon(cmdline_args)
        if res is not None:
            if not server.on_cuda(res.get("device")):
                raise RuntimeError("the daemon ran the job on %s, not on "
                                   "CUDA" % res.get("device"))
            if not res.get("ok"):
                sys.stderr.write("ERROR (daemon job): %s\n" % res.get("error"))
                raise SystemExit(1)
            print("\nAll done! WITCH-TPU (torch) finished in %.1f seconds "
                  "(resident daemon; job ran %.1fs)..."
                  % (time.time() - s1, res.get("seconds", 0.0)))
            return res.get("output")
    device = resolve_device()
    from .cli import init_parser
    from .config import Configs, build_configs
    from .pipeline import main_alignment_process

    build_configs(init_parser(), cmdline_args)
    Configs.log("WITCH-TPU (torch, %s) is running with: %s"
                % (device, " ".join(cmdline_args)))
    s1 = time.time()
    out = main_alignment_process()        # no card index: the mesh may form
    s2 = time.time()
    Configs.log("WITCH-TPU (torch) finished in {} seconds...".format(s2 - s1))
    print("\nAll done! WITCH-TPU (torch) finished in {:.1f} seconds..."
          .format(s2 - s1))
    return out
