from .model import GraphContainer, SequenceGraph
from .coordinates import GraphCoordinates

__all__ = ["GraphContainer", "SequenceGraph", "GraphCoordinates"]
