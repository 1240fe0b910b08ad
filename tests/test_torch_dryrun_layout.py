"""The dry run's layout against the reference's (``repro_torch.launch.
dryrun`` vs ``repro.launch.dryrun``).

The reference runs in one subprocess: importing ``repro.launch.dryrun``
forces 512 placeholder host devices in its first lines, and its
``build_cell`` gives every argument of every arch × shape cell on both
production meshes as a ``jax.ShapeDtypeStruct`` with a ``NamedSharding``;
nothing is compiled. Each leaf's sanitized spec, shape and dtype, its
bytes on one device (``sharding.shard_shape``) and each device's
argument bytes must equal the port's exactly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL, SHAPES, shape_applicable
from repro_torch.launch import dryrun as D

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = ("single", "multi")
CELLS = [(a, s) for a in sorted(ALL) for s in SHAPES
         if not shape_applicable(ALL[a], SHAPES[s])]

_SCRIPT = r"""
import json, sys
import numpy as np
from repro.launch import dryrun as D   # its first lines: 512 host devices
import jax
from repro.configs import ALL, SHAPES, shape_applicable

def key(path):
    out = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
    return "/" + "/".join(out)

def norm(entry):
    return list(entry) if isinstance(entry, tuple) else entry

out = {}
for mk in ("single", "multi"):
    mesh = D.make_production_mesh(multi_pod=(mk == "multi"))
    for a in sorted(ALL):
        for s in SHAPES:
            if shape_applicable(ALL[a], SHAPES[s]):
                continue
            _, args, mf, _ = D.build_cell(a, s, mesh)
            rows = {}
            for path, x in jax.tree_util.tree_flatten_with_path(args)[0]:
                spec = list(x.sharding.spec)
                spec += [None] * (len(x.shape) - len(spec))
                shard = x.sharding.shard_shape(x.shape)
                rows[key(path)] = [list(x.shape), str(x.dtype),
                                   [norm(e) for e in spec],
                                   int(np.prod(shard)) * x.dtype.itemsize]
            out[f"{a}|{s}|{mk}"] = {"leaves": rows, "model_flops": mf,
                                    "n_devices": int(mesh.size)}
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout)


@pytest.fixture(scope="module")
def meshes():
    return {mk: D.production_mesh(mk) for mk in MESHES}


def _norm(entry):
    return list(entry) if isinstance(entry, tuple) else entry


def _port(arch, shape, mesh):
    _, args, mf, kw = D.build_cell(arch, shape, mesh)
    memo = {}
    rows = {}
    for path, s in D._named_leaves(args):
        rows[path] = [list(s.shape), str(s.dtype).replace("torch.", ""),
                      [_norm(e) for e in s.sharding.spec],
                      int(D._block_bytes(s, mesh, memo).max())]
    return rows, mf, D.cell_layout(mesh, args, kw)


def test_every_applicable_cell_is_compared(ref):
    assert len(CELLS) == 33
    assert set(ref) == {f"{a}|{s}|{mk}" for a, s in CELLS for mk in MESHES}


@pytest.mark.parametrize("mk", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_layout_equals_the_reference(ref, meshes, arch, shape, mk):
    want = ref[f"{arch}|{shape}|{mk}"]
    rows, mf, layout = _port(arch, shape, meshes[mk])
    assert rows == want["leaves"]
    assert mf == want["model_flops"]
    assert meshes[mk].size == want["n_devices"]
    per_dev = sum(r[3] for r in want["leaves"].values())
    assert layout["memory"]["argument_bytes"] == per_dev


def test_every_position_holds_an_equal_block(meshes):
    """The sanitized specs divide every dim they shard, so the fullest
    device is every device: each position's block of each leaf has the
    same bytes (shard_index read at all 512 positions)."""
    mesh = meshes["multi"]
    _, args, _, _ = D.build_cell("qwen3-8b", "train_4k", mesh)
    memo = {}
    for _, s in D._named_leaves(args):
        b = D._block_bytes(s, mesh, memo)
        assert b.shape == (512,) and (b == b[0]).all()
    full = sum(int(np.prod(s.shape)) * torch.empty((), dtype=s.dtype)
               .element_size() for _, s in D._named_leaves(args))
    assert sum(int(D._block_bytes(s, mesh, memo)[0])
               for _, s in D._named_leaves(args)) < full
