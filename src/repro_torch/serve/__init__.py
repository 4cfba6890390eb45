"""Serving: generation + host-side batched engine, and the concurrent
multi-tenant DSE service frontend."""

from .dse_service import Busy, DSEService, QueryHandle
from .engine import Request, ServeEngine, generate, make_generate

__all__ = ["generate", "make_generate", "ServeEngine", "Request",
           "DSEService", "QueryHandle", "Busy"]
