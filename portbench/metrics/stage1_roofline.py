"""Slab sweep kernels: stage 1's least time on the card over its mean
span (%)."""
from portbench.readers import stage1_roofline as read  # noqa: F401
