"""Serving: the concurrent multi-tenant DSE service frontend."""

from .dse_service import Busy, DSEService, QueryHandle

__all__ = ["DSEService", "QueryHandle", "Busy"]
