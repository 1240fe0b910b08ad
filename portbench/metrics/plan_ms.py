"""Engine build: the plan, mean ``Engine.timings["plan_s"]`` (ms)."""
from portbench.readers import plan_ms as read  # noqa: F401
