from .gssw import GraphSW, GraphMapping
from .graph_aligner import GraphAligner

__all__ = ["GraphSW", "GraphMapping", "GraphAligner"]
