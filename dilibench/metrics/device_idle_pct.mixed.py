"""device_idle_pct.mixed: the share of the traced window in which no
operation ran on the device, in percent (mixed read and write cells)."""

from dilibench.trace import idle_pct as read  # noqa: F401
