"""HTTP serving layer (stdlib, in-process models)."""
from .app import ServiceState, make_handler, make_server, parse_multipart

__all__ = ["ServiceState", "make_handler", "make_server", "parse_multipart"]
