"""DBSCAN driver: mean ``n_rounds``, hooking rounds a call."""
from portbench.readers import hook_rounds as read  # noqa: F401
