"""repro_torch's AdamW (``train/optimizer.py``) and the checkpoint's
NamedTuples, on the CPU against the JAX reference.

The reference's three optimizer tests (``tests/test_optimizer.py``) run on
the port; ``apply`` of both packages on the same numpy parameters,
gradients and state for 3 steps with clipping active agree to rtol 1e-5
(the reference's own bar) with ``step`` equal; ``schedule`` at steps
0-120 to rtol 1e-6. The checkpoint restores a NamedTuple as its own type
(it restored a plain tuple, so a trainer's resume broke), and a
``TrainState`` the reference's ``ckpt.save`` wrote restores in the port
with the same fields and bits.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as ttrainer


def test_adamw_matches_numpy_reference():
    cfg = opt.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8,
                          weight_decay=0.01, clip_norm=1e9,
                          warmup_steps=0, total_steps=10, min_lr_frac=1.0)
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = {"w": torch.tensor([0.1, 0.2, -0.3])}
    pn = p["w"].numpy().astype(np.float64)   # before the in-place update
    state = opt.init(p)
    p1, state, m = opt.apply(cfg, p, g, state)

    # numpy reference (bias-corrected adam + decoupled weight decay)
    gn = g["w"].numpy().astype(np.float64)
    m1 = 0.1 * gn
    v1 = 0.01 * gn * gn
    mh = m1 / (1 - 0.9)
    vh = v1 / (1 - 0.99)
    expect = pn - 0.1 * (mh / (np.sqrt(vh) + 1e-8) + 0.01 * pn)
    np.testing.assert_allclose(p1["w"].numpy(), expect, rtol=1e-5)
    assert int(state.step) == 1
    assert p1["w"] is p["w"]   # written in place


def test_clipping_caps_update_norm():
    cfg = opt.AdamWConfig(lr=1.0, clip_norm=0.001, weight_decay=0.0,
                          warmup_steps=0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    state = opt.init(p)
    _, _, metrics = opt.apply(cfg, p, g, state)
    assert float(metrics["grad_norm"]) == 200.0  # pre-clip norm reported


def test_schedule_warmup_and_cosine():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                          min_lr_frac=0.1)
    lr0 = float(opt.schedule(cfg, torch.tensor(0, dtype=torch.int32)))
    lr5 = float(opt.schedule(cfg, torch.tensor(5, dtype=torch.int32)))
    lr10 = float(opt.schedule(cfg, torch.tensor(10, dtype=torch.int32)))
    lr_end = float(opt.schedule(cfg, torch.tensor(110, dtype=torch.int32)))
    assert lr0 == 0.0 and abs(lr5 - 0.5) < 1e-6 and abs(lr10 - 1.0) < 1e-6
    assert abs(lr_end - 0.1) < 1e-3
    prev = lr10
    for s in range(20, 111, 10):
        cur = float(opt.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        assert cur <= prev + 1e-9
        prev = cur


@pytest.mark.parametrize("warmup,total", [(10, 110), (0, 50), (100, 100)])
def test_schedule_matches_reference(warmup, total):
    cfg = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
               min_lr_frac=0.1)
    for s in range(121):
        ref = np.asarray(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(s)))
        port = opt.schedule(opt.AdamWConfig(**cfg),
                            torch.tensor(s, dtype=torch.int32))
        assert port.dtype == torch.float32
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-6, err_msg=s)


def _tree(rng):
    return {"a": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                  "b": rng.standard_normal((3,)).astype(np.float32)},
            "z": rng.standard_normal((2, 2, 2)).astype(np.float32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("clip", [0.5, 1e9])
def test_apply_matches_reference_over_three_steps(clip):
    """The same numpy parameters, gradients and state through both
    packages' ``apply`` for 3 steps; with clip 0.5 every step clips."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, clip_norm=clip,
              weight_decay=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    jp, js = params, jopt.init(params)
    tp = _torch(params)
    ts = opt.init(tp)
    for g in grads:
        jp, js, jm = jopt.apply(jcfg, jp, g, js)
        tp, ts, tm = opt.apply(tcfg, tp, _torch(g), ts)
        if clip < 1:
            assert float(jm["grad_norm"]) > clip
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            for jl, tl in zip(jax.tree.leaves(jt), tckpt.tree_flatten(tt)[0]):
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=1e-5)
        assert ts.step.dtype == torch.int32
        assert int(ts.step) == int(js.step)


class _Pair(NamedTuple):
    m: dict
    step: object


def test_checkpoint_restores_a_namedtuple_as_its_type(tmp_path):
    """The smallest input of the fault: a NamedTuple of a dict and an
    int32 scalar restored as a plain tuple."""
    tree = _Pair({"w": torch.arange(3.0)},
                 torch.tensor(7, dtype=torch.int32))
    tckpt.save(str(tmp_path), 1, tree)
    out, meta = tckpt.restore(str(tmp_path), tree)
    assert type(out) is _Pair and meta["step"] == 1
    np.testing.assert_array_equal(out.m["w"], np.arange(3.0))
    assert out.step.dtype == np.int32 and int(out.step) == 7
    plain, _ = tckpt.restore(str(tmp_path), ({"w": 0}, 0))
    assert type(plain) is tuple and type(plain[0]) is dict


def test_reference_train_state_restores_in_the_port(tmp_path):
    """The reference's ``ckpt.save`` of a ``TrainState`` (leaves by index,
    NamedTuple fields in order, dict keys sorted) restores into the
    port's ``TrainState`` with the same fields and bits."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jstate = jtrainer.TrainState(params, jopt.OptState(
        _tree(rng), _tree(rng), jnp.int32(5)))
    jckpt.save(str(tmp_path), 5, jstate)
    like = ttrainer.TrainState(_torch(params), opt.init(_torch(params)))
    out, meta = tckpt.restore(str(tmp_path), like)
    assert type(out) is ttrainer.TrainState
    assert type(out.opt) is opt.OptState and meta["step"] == 5
    for name, j, t in (("params", jstate.params, out.params),
                       ("m", jstate.opt.m, out.opt.m),
                       ("v", jstate.opt.v, out.opt.v)):
        jl = jax.tree_util.tree_flatten_with_path(j)[0]
        tl = tckpt.tree_flatten(t)[0]
        assert len(jl) == len(tl), name
        for (path, a), b in zip(jl, tl):
            assert b.dtype == np.float32, (name, path)
            np.testing.assert_array_equal(b, np.asarray(a),
                                          err_msg=f"{name} {path}")
    assert out.opt.step.dtype == np.int32 and int(out.opt.step) == 5
    # and the port's save of it restores in the reference
    tckpt.save(str(tmp_path / "port"), 5, out)
    back, _ = jckpt.restore(str(tmp_path / "port"), jstate)
    assert type(back) is jtrainer.TrainState
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
