"""The cluster cells' tail: the 95th percentile of the window's
clusterings (host clock). The plan's host time sets it, so it is a
per-layer metric that moves ``dbscan_ms``."""
from portbench.readers import p95_ms as read  # noqa: F401
