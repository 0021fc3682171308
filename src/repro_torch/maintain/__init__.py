"""Maintenance knobs.  Only `MaintenanceConfig` is here, so `IndexConfig`
keeps the reference's fields; accounting, the splice flattener and the
scheduler wait for their slice (see ROADMAP.md)."""

from .config import MaintenanceConfig

__all__ = ["MaintenanceConfig"]
