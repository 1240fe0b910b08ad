"""End to end: the device memory the window's calls held at their peak
(GiB)."""
from portbench.readers import peak_gib as read  # noqa: F401
