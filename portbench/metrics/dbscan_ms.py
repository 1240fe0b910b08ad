"""End to end: milliseconds a call, points in to labels on the host, the
window's seconds over the calls completed in it (host clock)."""
from portbench.readers import call_ms as read  # noqa: F401
