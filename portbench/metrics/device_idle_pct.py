"""Device: the traced window's share with no device operation (%)."""
from portbench.readers import device_idle_pct as read  # noqa: F401
