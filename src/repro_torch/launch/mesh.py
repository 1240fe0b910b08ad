"""Device meshes (the port of ``repro.launch.mesh``).

PyTorch has no GSPMD, so a mesh here is plain data: named axes, their
sizes, and the device at each position, row-major over the axes as
``jax.make_mesh`` lays out its ``devices`` array. The sharding rules
(``models.sharding``) map a tensor's logical axes onto these names, and
``models.sharding.shard_index`` says which block of a tensor each position
holds. A function, not a module-level constant, so importing this module
touches no device.

Production topology (the reference's, TPU v5e): 16×16 = 256 chips per
pod; the multi-pod mesh adds a leading "pod" axis (2 pods = 512 chips) for
pure data parallelism across pods.
"""
from __future__ import annotations

import math

import torch

from ..core.engines import resolve_device


class Mesh:
    """Named axes over devices. ``shape`` maps each axis name to its size
    (in axis order), ``size`` is the number of positions and
    ``devices[i]`` the device at flat position ``i`` (row-major). One
    device may stand at several positions, as D thread ranks share one
    card."""

    def __init__(self, shape, axis_names, devices):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.size:
            raise ValueError(f"a mesh of shape {shape} holds {self.size} "
                             f"devices, got {len(self.devices)}")

    def coords(self, position) -> dict:
        """Axis name → coordinate of ``position`` (a flat row-major index
        or a tuple of coordinates)."""
        if isinstance(position, int):
            if not 0 <= position < self.size:
                raise IndexError(f"position {position} of a mesh of "
                                 f"{self.size}")
            out = {}
            for a in reversed(self.axis_names):
                position, out[a] = divmod(position, self.shape[a])
            return {a: out[a] for a in self.axis_names}
        position = tuple(position)
        if len(position) != len(self.axis_names) or any(
                not 0 <= c < self.shape[a]
                for a, c in zip(self.axis_names, position)):
            raise IndexError(f"position {position} of a mesh of shape "
                             f"{tuple(self.shape.values())}")
        return dict(zip(self.axis_names, position))


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh over the first ``prod(shape)`` of ``devices`` (default every
    visible card, raising without one: pass ``devices`` for a CPU mesh);
    fewer devices than positions raise ``ValueError``, as
    ``jax.make_mesh`` does."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = math.prod(int(s) for s in shape)
    if n > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the "
                         f"product of mesh_shape {tuple(shape)}")
    return Mesh(shape, axes, devices[:n])


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
