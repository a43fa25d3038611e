from .build import load_library

__all__ = ["load_library"]
