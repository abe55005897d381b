from . import plot

__all__ = ["plot"]
