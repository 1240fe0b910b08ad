"""repro_torch's mesh, sharding rules, elastic restart and compressed
collectives (``launch/mesh.py``, ``models/sharding.py``,
``distributed/elastic.py``, ``distributed/collectives.py``) on the CPU
against the JAX reference.

The reference runs once per module, in one subprocess with 8 fake host
devices (as ``tests/test_distributed.py`` runs it); its outputs go
through an ``.npz``:

  * every device's ``addressable_shards[i].index`` of arrays placed with
    the reference's ``sharding_for`` on a (4, 2) and a (2, 2)
    ("data", "model") mesh, for ("embed", "ff"), ("batch", None) and
    granite's full-shape embedding table (vocab 49,155 divides neither
    model axis, so ``sanitize_spec`` drops it); the port's
    ``shard_index`` must give the same block at the same mesh position;
  * ``test_compressed_psum_parity``'s case (8 ranks; ``w`` 8×16, ``b`` 8×1
    linspaces, a row a rank) through ``psum_compressed`` for "none",
    "bf16" and "int8", each rank's residual, the int8 codes of each rank,
    and a second call fed that residual. The port runs the 8 ranks as a
    ``ThreadGroup`` on the CPU: "none" to rtol 1e-6, "bf16" and "int8"
    within the reference's bars of the exact sum (1e-2, 2e-2) and to rtol
    1e-6 of the reference's outputs, the codes bitwise.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed import collectives as C
from repro_torch.distributed import comm, elastic
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as sh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"m42": (4, 2), "m22": (2, 2)}
ARRAYS = {"ef": ((8, 12), ("embed", "ff")),
          "bn": ((8, 3), ("batch", None)),
          "embed": ((49155, 1024), ("vocab", "embed"))}
METHODS = ("none", "bf16", "int8")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Eight rank threads of small tensor operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("shard") / "ref.npz"
    script = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {ROOT + "/src"!r})
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.distributed.dbscan_dist import shard_map
    from repro.distributed import collectives as C
    from repro.launch.mesh import make_mesh
    from repro.models import sharding as sh
    res = {{}}
    for mk, shape in {MESHES!r}.items():
        mesh = make_mesh(shape, ("data", "model"))
        for ak, (ashape, axes) in {ARRAYS!r}.items():
            s = sh.sharding_for(mesh, axes, shape=ashape)
            res[f"{{mk}}/{{ak}}/spec"] = np.asarray(repr(tuple(s.spec)))
            x = jax.device_put(np.zeros(ashape, np.int8), s)
            where = {{sd.device.id: sd.index for sd in x.addressable_shards}}
            idx = []
            for pos in np.ndindex(mesh.devices.shape):
                index = where[mesh.devices[pos].id]
                idx.append([sl.indices(n)[:2]
                            for sl, n in zip(index, ashape)])
            res[f"{{mk}}/{{ak}}/index"] = np.asarray(idx)
    mesh = make_mesh((8,), ("data",))
    grads = {{"w": jnp.linspace(-1, 1, 128).reshape(8, 16),
              "b": jnp.linspace(0, 1, 8).reshape(8, 1)}}

    def red(method, error):
        def f(g, e):
            g = jax.tree.map(lambda x: x.reshape(x.shape[1:]), g)
            e = None if method == "none" else e[0]
            out, r = C.psum_compressed(g, "data", method=method, error=e)
            r = jnp.zeros((17,)) if r is None else r
            return out, r[None]
        return shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P(), P("data")), check_vma=False)(
                             grads, error)

    def codes(g):
        g = jax.tree.map(lambda x: x.reshape(x.shape[1:]), g)
        flat, _ = C._flatten_bucket(g)
        local = jnp.maximum(jnp.max(jnp.abs(flat)), 1e-12) / 127.0
        gscale = jax.lax.pmax(local, "data")
        q = jnp.clip(jnp.round(flat / gscale), -127, 127).astype(jnp.int8)
        return q[None], gscale[None]

    q, gs = shard_map(codes, mesh=mesh, in_specs=(P("data"),),
                      out_specs=(P("data"), P("data")),
                      check_vma=False)(grads)
    res["int8/codes"], res["int8/gscale"] = np.asarray(q), np.asarray(gs)
    for k in grads:
        res[f"grads/{{k}}"] = np.asarray(grads[k])
    zero = jnp.zeros((8, 17))
    for method in {METHODS!r}:
        out, resid = red(method, zero)
        out2, resid2 = red(method, resid)
        for k in out:
            res[f"{{method}}/out/{{k}}"] = np.asarray(out[k])
            res[f"{{method}}/out2/{{k}}"] = np.asarray(out2[k])
        res[f"{{method}}/resid"] = np.asarray(resid)
        res[f"{{method}}/resid2"] = np.asarray(resid2)
    np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def cpu_mesh(shape, axes=("data", "model")):
    return tmesh.make_mesh(shape, axes, devices=["cpu"] * 8)


@pytest.mark.parametrize("mk", sorted(MESHES))
@pytest.mark.parametrize("ak", sorted(ARRAYS))
def test_shard_index_matches_reference(ref, mk, ak):
    mesh = cpu_mesh(MESHES[mk])
    shape, axes = ARRAYS[ak]
    s = sh.sharding_for(mesh, axes, shape=shape)
    assert repr(s.spec) == str(ref[f"{mk}/{ak}/spec"])
    got = [[sl.indices(n)[:2] for sl, n in zip(
        sh.shard_index(shape, s, pos), shape)] for pos in range(mesh.size)]
    np.testing.assert_array_equal(np.asarray(got), ref[f"{mk}/{ak}/index"])
    # the same block by coordinates as by flat position
    assert sh.shard_index(shape, s, (1, 1)) == sh.shard_index(
        shape, s, mesh.shape["model"] + 1)


def test_granite_embed_spec_drops_the_vocab_axis():
    mesh = cpu_mesh((4, 2))
    s = sh.sharding_for(mesh, ("vocab", "embed"), shape=(49155, 1024))
    assert s.spec == (None, "data")
    assert sh.sanitize_spec(mesh, (49156, 1024), ("model", "data")) == \
        ("model", "data")
    rules = sh.default_rules(tmesh.make_mesh((2, 2, 2),
                                             ("pod", "data", "model"),
                                             devices=["cpu"] * 8))
    assert rules["batch"] == ("pod", "data")
    assert sh.serve_rules(mesh)["embed"] is None


def test_mesh_shapes_and_errors(monkeypatch):
    mesh = cpu_mesh((4, 2))
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.coords(5) == {"data": 2, "model": 1}
    assert mesh.coords((2, 1)) == mesh.coords(5)
    with pytest.raises(IndexError):
        mesh.coords(8)
    with pytest.raises(ValueError, match="must be >="):
        tmesh.make_production_mesh(devices=["cpu"] * 8)
    prod = tmesh.make_production_mesh(multi_pod=True, devices=["cpu"] * 600)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert prod.size == 512 == len(prod.devices)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_mesh((1,), ("data",))


def test_straggler_policy():
    p = elastic.StragglerPolicy(slow_steps_budget=3)
    assert p.decide(2, 8) is None
    act = p.decide(5, 8)
    assert act["action"] == "shrink" and act["mesh_shape"][0] * \
        act["mesh_shape"][1] == 4
    assert elastic.StragglerPolicy().decide(5, 3)["action"] == "restart"


@pytest.mark.parametrize("n,prefer,shape", [
    (4, 2, (2, 2)), (8, 16, (1, 8)), (256, 16, (16, 16)), (12, 16, (1, 12)),
    (6, 4, (2, 3)), (7, 16, (1, 7)), (1, 16, (1, 1))])
def test_plan_mesh(n, prefer, shape):
    assert elastic.plan_mesh(n, prefer_model=prefer) == \
        (shape, ("data", "model"))


def test_elastic_reshard(tmp_path):
    """The reference's ``test_elastic_reshard``: a checkpoint of an 8×8
    tensor restores onto a (2, 2) mesh of 4 devices; the full tensor and
    each block equal."""
    d = str(tmp_path)
    x = torch.arange(64.0).reshape(8, 8)
    tckpt.save(d, 1, {"w": x})
    shape, axes = elastic.plan_mesh(4, prefer_model=2)
    assert shape == (2, 2)
    mesh4 = tmesh.make_mesh(shape, axes, devices=["cpu"] * 4)
    state, meta = elastic.reshard_state(d, {"w": x}, mesh4,
                                        axes_tree={"w": ("embed", "ff")})
    w = state["w"]
    assert isinstance(w, sh.Sharded) and w.mesh.size == 4
    assert w.spec == ("data", "model") and meta["step"] == 1
    assert torch.equal(w.full(), x)
    for pos, blk in enumerate(w.blocks):
        c = mesh4.coords(pos)
        assert torch.equal(blk, x[4 * c["data"]:4 * c["data"] + 4,
                                  4 * c["model"]:4 * c["model"] + 4])
    plain, _ = elastic.reshard_state(d, {"w": x}, mesh4)
    assert isinstance(plain["w"], np.ndarray)
    # a resharded state saves whole
    tckpt.save(d, 2, state)
    again, _ = tckpt.restore(d, {"w": x})
    np.testing.assert_array_equal(again["w"], x.numpy())
    mesh, st, _ = elastic.elastic_restart(
        d, {"w": x}, 4, axes_tree={"w": ("embed", "ff")},
        devices=["cpu"] * 8)
    assert mesh.shape == {"data": 1, "model": 4}
    assert [tuple(b.shape) for b in st["w"].blocks] == [(8, 2)] * 4


def _rank(cm, method, grads):
    """One rank's two calls: (out, resid, out2, resid2, int8 codes)."""
    g = {k: torch.from_numpy(v[cm.axis_index()].copy())
         for k, v in grads.items()}
    e0 = None if method == "none" else C.init_error_feedback(g)
    out, resid = C.psum_compressed(g, cm, method=method, error=e0)
    e1 = None if method == "none" else resid
    out2, resid2 = C.psum_compressed(g, cm, method=method, error=e1)
    flat = torch.cat([g["b"].reshape(-1), g["w"].reshape(-1)])
    codes = C.int8_quantize(flat, cm)
    return out, resid, out2, resid2, codes


@pytest.mark.parametrize("method", METHODS)
def test_psum_compressed_matches_reference(ref, method):
    g = {k: ref[f"grads/{k}"] for k in ("b", "w")}   # the same f32 inputs
    res = comm.ThreadGroup(8, "cpu").run(_rank, method, g)
    exact = {k: v.mean(0) for k, v in g.items()}
    rtol_exact = {"none": 1e-6, "bf16": None, "int8": None}[method]
    bar = {"none": None, "bf16": 1e-2, "int8": 2e-2}[method]
    for out, _, out2, _, _ in res:
        for k in exact:
            for o, tag in ((out, "out"), (out2, "out2")):
                r = ref[f"{method}/{tag}/{k}"]
                assert o[k].dtype == torch.float32 and o[k].shape == r.shape
                np.testing.assert_allclose(o[k].numpy(), r, rtol=1e-6,
                                           atol=1e-7, err_msg=f"{tag} {k}")
            if rtol_exact:
                np.testing.assert_allclose(out[k].numpy(), exact[k],
                                           rtol=rtol_exact, atol=1e-7)
            else:
                assert float(np.abs(out[k].numpy() - exact[k]).max()) < bar
    if method == "none":
        assert all(r[1] is None and r[3] is None for r in res)
        return
    for rank, (_, resid, _, resid2, _) in enumerate(res):
        assert resid.shape == (17,) and resid.dtype == torch.float32
        np.testing.assert_allclose(resid.numpy(), ref[f"{method}/resid"][rank],
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(resid2.numpy(),
                                   ref[f"{method}/resid2"][rank],
                                   rtol=1e-6, atol=1e-9)
    if method == "int8":
        for rank, (*_, (q, gscale)) in enumerate(res):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), ref["int8/codes"][rank])
            assert float(gscale) == float(ref["int8/gscale"][rank])


def test_psum_compressed_rejects_an_unknown_method():
    with pytest.raises(ValueError):
        comm.ThreadGroup(2, "cpu").run(
            lambda cm: C.psum_compressed({"a": torch.ones(2)}, cm,
                                         method="fp8"))
