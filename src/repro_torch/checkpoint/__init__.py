"""Step-atomic checkpointing (numpy container, sync + async)."""

from .async_ckpt import AsyncCheckpointer
from .store import latest_step, list_steps, restore, save

__all__ = ["save", "restore", "latest_step", "list_steps", "AsyncCheckpointer"]
