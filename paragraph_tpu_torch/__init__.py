"""paragraph_tpu_torch — the PyTorch / CUDA port of paragraph_tpu.

The port runs the multigrmpy main path (VCF → graphs → paired graph
Smith-Waterman scoring → host traceback, counting and float64
genotyping → VCF) with the scoring fill as a hand-written CUDA kernel for
Hopper (``ops/csrc/paired_sw.cu``). Host modules that never import jax are
imported from ``paragraph_tpu``; every module on the path that would pull
in jax has its counterpart here, under the same name.

The device is chosen by the caller (``device="cuda"`` or ``"cpu"``) and
is never switched behind the caller's back: on ``cuda`` a build, launch or
scoring failure raises. ``cpu`` runs the plain PyTorch version of the fill.
"""

__version__ = "0.1.0"


def resolve_device(device):
    """The ``torch.device`` for a caller's device argument.

    Raises RuntimeError when CUDA is asked for and no card is visible.
    For CUDA the context is initialised here, so that the pipelined
    orchestrator can hide the card from its worker processes afterwards
    (``CUDA_VISIBLE_DEVICES=""`` is read when CUDA initialises).
    ``torch`` is imported here, not at package import: worker processes
    import the host half of the port and never touch torch.
    """
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false")
        torch.cuda.init()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
