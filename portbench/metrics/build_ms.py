"""Engine build: the device build after the plan, mean ``build_s -
plan_s`` (ms)."""
from portbench.readers import build_ms as read  # noqa: F401
