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
    and raises without it."""
    import sys
    import time

    device = resolve_device()
    cmdline_args = sys.argv[1:] if argv is None else argv
    from .cli import init_parser
    from .config import Configs, build_configs
    from .pipeline import main_alignment_process

    build_configs(init_parser(), cmdline_args)
    Configs.log("WITCH-TPU (torch, %s) is running with: %s"
                % (device, " ".join(cmdline_args)))
    s1 = time.time()
    out = main_alignment_process(device)
    s2 = time.time()
    Configs.log("WITCH-TPU (torch) finished in {} seconds...".format(s2 - s1))
    print("\nAll done! WITCH-TPU (torch) finished in {:.1f} seconds..."
          .format(s2 - s1))
    return out
