from .mesh import sharded_population_genotyping

__all__ = ["sharded_population_genotyping"]
