"""Durability knobs.  Only `DurabilityConfig` is here, so `IndexConfig`
keeps the reference's fields; the WAL and checkpoints wait for their
slice (see ROADMAP.md)."""

from .config import DurabilityConfig

__all__ = ["DurabilityConfig"]
