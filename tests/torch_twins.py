"""Twin objects for the tests that hold the PyTorch port to the JAX package.

The port keeps its own copies of the host modules, so each side gets
objects of its own classes built from the same content: the tests build
the port's graphs and hand the JAX package twins with the same node
names, sequences, edges and edge labels.
"""
from paragraph_tpu.graph.model import SequenceGraph as JaxSequenceGraph


def jax_graph(g):
    """The JAX package's SequenceGraph with the content of the port's `g`."""
    out = JaxSequenceGraph(g.node_names, g.node_seqs)
    for f, t in g.edges():
        out.add_edge(f, t)
        for label in g.edge_labels(f, t):
            out.add_label_to_edge(f, t, label)
    return out


def jax_graphs(graphs):
    """jax_graph of each graph; a graph listed twice gets one twin, so
    scorers that share work between repeated graphs see the same layout."""
    twins = {}
    return [twins.setdefault(id(g), jax_graph(g)) for g in graphs]
