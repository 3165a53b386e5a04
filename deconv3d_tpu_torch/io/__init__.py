from . import fits

__all__ = ["fits"]
