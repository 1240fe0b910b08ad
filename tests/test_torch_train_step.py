"""repro_torch's train step (``train/trainer.make_train_step``) on the CPU
against the JAX reference's, for all ten architectures at their reduced
size, in f32.

Both packages start from the same state (the reference's ``init_params``
at key 0 and ``opt.init``, carried across with ``state_from_jax``) and
take one step on the same batch (the reference's ``synth_batch``, as
numpy). The reference's gradients are ``jax.value_and_grad`` of its
``loss_fn`` and its update its ``optimizer.apply``, jitted, which is what
its ``make_train_step`` does; the port's gradients are read where its
step hands them to ``optimizer.apply``. The loss, its parts, every
gradient leaf, and the new parameters, moments and metrics are held at
rtol 2e-4 / atol 2e-5 (``tests/test_moe.py``'s bar), ``step`` equal.
Also the reference's ``test_train_step`` assertions (finite, parameters
moved) and ``test_moe_grad_flows`` on the port, remat ``"block"`` against
``"none"`` (bitwise here, with fewer bytes saved for the backward pass),
and ``microbatch=2`` against the reference's ``microbatch=2`` step.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.distributed.checkpoint import tree_flatten
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

ARCHS = sorted(jconfigs.ALL)
B, S = 2, 64
OCFG = dict(lr=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(port, ref, what):
    ref = np.asarray(ref)
    port = port.detach().numpy()
    assert port.shape == ref.shape and port.dtype == ref.dtype, what
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=2e-5, err_msg=what)


def ref_state(cfg, seed=0):
    """The reference's initial ``TrainState``, as numpy."""
    params = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray,
                        jtrainer.TrainState(params, jopt.init(params)))


def ref_batch(cfg, b=B, s=S, seed=1):
    return jax.tree.map(np.asarray,
                        JM.synth_batch(cfg, b, s, jax.random.PRNGKey(seed)))


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def port_step(cfg, state, batch, microbatch=0):
    """One port step; returns (new state, metrics, the gradients handed to
    ``optimizer.apply``)."""
    seen = {}
    real = topt.apply

    def recording(ocfg, params, grads, st):
        seen["grads"] = [g.clone() for g in tree_flatten(grads)[0]]
        return real(ocfg, params, grads, st)

    topt.apply = recording
    try:
        step = ttrainer.make_train_step(cfg, topt.AdamWConfig(**OCFG),
                                        microbatch=microbatch)
        new, metrics = step(state, to_torch(batch))
    finally:
        topt.apply = real
    return new, metrics, seen["grads"]


def compare_states(jstate, tstate, what):
    for name, j, t in (("params", jstate.params, tstate.params),
                       ("m", jstate.opt.m, tstate.opt.m),
                       ("v", jstate.opt.v, tstate.opt.v)):
        jl = jax.tree_util.tree_flatten_with_path(j)[0]
        tl = tree_flatten(t)[0]
        assert len(jl) == len(tl)
        for (path, a), b in zip(jl, tl):
            close(b, a, f"{what} {name} {jax.tree_util.keystr(path)}")
    assert tstate.opt.step.dtype == torch.int32
    assert int(tstate.opt.step) == int(jstate.opt.step)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    jcfg = jconfigs.ALL[name].reduced()
    tcfg = tconfigs.ALL[name].reduced()
    state = ref_state(jcfg)
    batch = ref_batch(jcfg)
    (lval, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b), has_aux=True))(
        state.params, batch)
    jparams, jopt_state, jm = jax.jit(jopt.apply, static_argnums=0)(
        jopt.AdamWConfig(**OCFG), state.params, grads, state.opt)

    tstate = ttrainer.state_from_jax(tcfg, state, device="cpu")
    before = [p.clone() for p in tree_flatten(tstate.params)[0]]
    new, tm, tgrads = port_step(tcfg, tstate, batch)

    close(tm["loss"], lval, f"{name} loss")
    for k in ("ce", "aux"):
        close(tm[k], aux[k], f"{name} {k}")
    for k in ("grad_norm", "lr"):
        close(tm[k], jm[k], f"{name} {k}")
    jg = jax.tree_util.tree_flatten_with_path(grads)[0]
    assert len(jg) == len(tgrads)
    for (path, a), b in zip(jg, tgrads):
        close(b, a, f"{name} grad {jax.tree_util.keystr(path)}")
    compare_states(jtrainer.TrainState(jparams, jopt_state), new, name)

    # the reference's test_train_step: finite, and the parameters moved
    assert bool(torch.isfinite(tm["loss"])) and \
        bool(torch.isfinite(tm["grad_norm"]))
    assert any(float((a - b.detach()).abs().max()) > 0
               for a, b in zip(before, tree_flatten(new.params)[0]))
    assert all(p.grad is None for p in tree_flatten(new.params)[0])


def test_moe_grad_flows():
    """The reference's ``test_moe_grad_flows`` on the port: every gradient
    of ``moe_ffn`` finite, and the router gets one (through the combine
    weights)."""
    gen = torch.Generator().manual_seed(2)
    d, f, e, k = 8, 16, 4, 2
    p = {"router": 0.5 * torch.randn(d, e, generator=gen),
         "w1": 0.3 * torch.randn(e, d, f, generator=gen),
         "w3": 0.3 * torch.randn(e, d, f, generator=gen),
         "w2": 0.3 * torch.randn(e, f, d, generator=gen)}
    for t in p.values():
        t.requires_grad_(True)
    x = torch.randn(1, 16, d, generator=gen)
    y, aux = tmoe.moe_ffn(x, p, n_experts=e, top_k=k)
    ((y ** 2).mean() + 0.01 * aux).backward()
    for name, leaf in p.items():
        assert bool(torch.isfinite(leaf.grad).all()), name
    assert float(p["router"].grad.abs().max()) > 0


class SavedBytes:
    """Bytes autograd saves for the backward pass while active."""

    def __init__(self):
        self.n = 0
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                               lambda x: x)

    def pack(self, x):
        self.n += x.numel() * x.element_size()
        return x

    def __enter__(self):
        self._hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self._hooks.__exit__(*exc)


@pytest.mark.parametrize("name", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "whisper-large-v3"])
def test_remat_block_equals_none(name):
    """``remat="block"`` recomputes each block in the backward pass: loss
    and gradients bitwise equal to ``"none"``'s on the CPU, and fewer
    bytes kept for the backward pass."""
    jcfg = jconfigs.ALL[name].reduced()
    batch = to_torch(ref_batch(jcfg))
    state = ref_state(jcfg)
    out = {}
    for remat in ("none", "block"):
        cfg = dataclasses.replace(tconfigs.ALL[name].reduced(), remat=remat)
        params = ttrainer.state_from_jax(cfg, state, device="cpu").params
        leaves = tree_flatten(params)[0]
        for p in leaves:
            p.requires_grad_(True)
        with SavedBytes() as saved:
            loss, _ = TM.loss_fn(cfg, params, batch)
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in leaves], saved.n)
    (l0, g0, n0), (l1, g1, n1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert n1 < n0, (n1, n0)


def test_remat_leaves_serving_alone():
    """Without anything requiring grad the block runs as it is: no
    checkpoint frame, the same logits."""
    cfg = tconfigs.ALL["qwen3-8b"].reduced()
    params = TM.init_params(cfg, 0, device="cpu")
    batch = TM.synth_batch(cfg, 1, 16, 0, train=False, device="cpu")
    calls = []
    real = torch.utils.checkpoint.checkpoint
    torch.utils.checkpoint.checkpoint = lambda *a, **k: calls.append(1) \
        or real(*a, **k)
    try:
        a = TM.forward(cfg, params, batch)[0]
        b = TM.forward(dataclasses.replace(cfg, remat="none"), params,
                       batch)[0]
    finally:
        torch.utils.checkpoint.checkpoint = real
    assert not calls and torch.equal(a, b)


def test_microbatch_matches_reference():
    """``microbatch=2``: the batch split along dim 0, gradients summed over
    the chunks and divided by 2; metrics the loss and the optimizer's."""
    name = "granite-moe-1b-a400m"
    jcfg = jconfigs.ALL[name].reduced()
    tcfg = tconfigs.ALL[name].reduced()
    state = ref_state(jcfg)
    batch = ref_batch(jcfg, b=4, s=32)
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt.AdamWConfig(**OCFG),
                                             microbatch=2))
    jnew, jm = jstep(jax.tree.map(jax.numpy.asarray, state), batch)
    tstate = ttrainer.state_from_jax(tcfg, state, device="cpu")
    new, tm, _ = port_step(tcfg, tstate, batch, microbatch=2)
    assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
    for k in tm:
        close(tm[k], jm[k], k)
    compare_states(jnew, new, "microbatch 2")


def test_state_from_jax_checks_its_input():
    cfg = tconfigs.ALL["qwen3-8b"].reduced()
    state = ref_state(jconfigs.ALL["qwen3-8b"].reduced())
    bad = jtrainer.TrainState(state.params, jopt.OptState(
        state.opt.m, state.opt.v, np.int64(0)))
    with pytest.raises(ValueError, match="int32"):
        ttrainer.state_from_jax(cfg, bad, device="cpu")
    m = dict(state.opt.m)
    m.pop("embed")
    with pytest.raises(ValueError, match="keys"):
        ttrainer.state_from_jax(cfg, jtrainer.TrainState(
            state.params, jopt.OptState(m, state.opt.v, state.opt.step)),
            device="cpu")
