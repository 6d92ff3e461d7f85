from .distributed import ShardedPairedSW, make_event_mesh
from .mesh import make_mesh, merged_edge_counts, sharded_population_genotyping

__all__ = ["ShardedPairedSW", "make_event_mesh", "make_mesh",
           "merged_edge_counts", "sharded_population_genotyping"]
