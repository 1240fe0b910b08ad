"""End to end, the re-run cells: the 95th percentile of the window's
calls, each on the host clock from the call to the labels on the
host (ms)."""
from portbench.readers import p95_ms as read  # noqa: F401
