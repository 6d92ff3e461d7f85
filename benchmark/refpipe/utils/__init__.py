from .numerics import c_round, f32

__all__ = ["c_round", "f32"]
