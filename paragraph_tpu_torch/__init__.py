"""paragraph_tpu_torch — the PyTorch / CUDA port of paragraph_tpu.

The port runs the multigrmpy main path (VCF → graphs → paired graph
Smith-Waterman scoring → host traceback, counting and float64
genotyping → VCF) with the scoring fill as a hand-written CUDA kernel for
Hopper (``ops/csrc/paired_sw.cu``), and the per-event path (the
``paragraph`` CLI, grmpy per event) with the single-graph fill as another
(``ops/csrc/graph_sw.cu``). The kernel benchmark tools
(``tools/kbench.py``, ``tools/kbench2.py``) time the paired kernel and
the ablation ladder of its column loop (``ops/csrc/kbench_sw.cu``).

The port imports nothing of ``paragraph_tpu``. Every host module it uses
(graph, io, reads, the host aligners, the float64 genotyping engines,
vcfupdate, schemas) is a copy at the same relative path here, and every
module whose JAX counterpart would pull in jax is rewritten here under
the same name.

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


def add_stats(total, stats: dict) -> None:
    """Sum one scorer's stats into `total` (no-op when it is None)."""
    if total is not None:
        for k, v in stats.items():
            total[k] = total.get(k, 0) + v
