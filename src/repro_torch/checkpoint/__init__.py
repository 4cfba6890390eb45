"""Step-atomic checkpointing (numpy container, no framework trees)."""

from .store import latest_step, list_steps, restore, save

__all__ = ["save", "restore", "latest_step", "list_steps"]
