from .read import Read, MAPPED, UNMAPPED, BAD_ALIGN

__all__ = ["Read", "MAPPED", "UNMAPPED", "BAD_ALIGN"]
