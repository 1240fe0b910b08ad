"""End to end: seconds from the process's start to the window's: imports,
CUDA's start, the kernels' build on a checkout's first run, the
datasets, engines built at set-up, and the warm calls."""
from portbench.readers import setup_s as read  # noqa: F401
