"""DBSCAN driver: mean ``timings["stage2_s"]`` (ms)."""
from portbench.readers import stage2_ms as read  # noqa: F401
