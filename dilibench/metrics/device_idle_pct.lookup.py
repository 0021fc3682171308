"""device_idle_pct.lookup: the share of the traced window in which no
operation ran on the device, in percent (lookup cells)."""

from dilibench.trace import idle_pct as read  # noqa: F401
