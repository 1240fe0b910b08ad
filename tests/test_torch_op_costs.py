"""The eager cost counter (``repro_torch.launch.op_costs``) against the
reference's loop-aware HLO walk (``repro.launch.hlo_costs``).

The five programs of ``tests/test_hlo_costs.py``, written in torch, give
the same exact counts; bytes are exact on hand-made programs; the memo
changes no count; and for each reduced arch the dot FLOPs of the loss
forward, its gradient, prefill and decode, traced on ``meta``, equal the
reference's ``loop_aware_costs`` on its compiled CPU program, except for
three causes, each pinned to its exact size from the config:

  * ``k1``: a product whose contraction has size 1 (an outer product:
    the backward of a batched matrix-vector product, hymba's SSM readout
    and xLSTM's mLSTM normaliser). PyTorch runs it as a ``bmm`` and it
    counts 2·|out|; XLA rewrites a ``dot`` with K = 1 into an elementwise
    multiply, which counts nothing.
  * ``carry``: the gradient of a scan's zero initial carry. The
    reference's backward scan runs the same body at every step, the first
    included, and drops that result; autograd computes no gradient that
    no tensor requires, so the port skips the first chunk's (mLSTM) or
    step's (sLSTM) carry products.
  * ``cse``: whisper's prefill projects the encoder output to the
    cross-attention K and V twice a layer, once for the cache and once
    inside the attention; XLA's common-subexpression pass merges the two,
    the port runs both.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL as REF_ALL
from repro.launch.hlo_costs import loop_aware_costs
from repro.models import model as RM
from repro_torch.configs import ALL
from repro_torch.distributed.checkpoint import tree_flatten
from repro_torch.launch import op_costs as oc
from repro_torch.models import model as M

aten = torch.ops.aten
B, S = 2, 64
PROGRAMS = ("forward", "gradient", "prefill", "decode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, *args):
    """``(fn(*args), OpCosts)``."""
    with oc.OpCosts() as c:
        out = fn(*args)
    return out, c


def _ref_flops(fn, *args):
    return loop_aware_costs(jax.jit(fn).lower(*args).compile().as_text())


# ---- the five programs of tests/test_hlo_costs.py ----------------------


def test_loop_flops_exact():
    def f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    _, c = _count(f, meta(32, 64, 64), meta(4, 64))
    assert c.flops == 2 * 4 * 64 * 64 * 32
    sds = jax.ShapeDtypeStruct
    r = _ref_flops(lambda ws, x: jax.lax.scan(
        lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0],
        sds((32, 64, 64), jnp.float32), sds((4, 64), jnp.float32))
    assert c.flops == r["flops"]


def test_nested_loop_multipliers():
    def f(ws, x):
        for w in ws:
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x

    _, c = _count(f, meta(8, 32, 32), meta(2, 32))
    assert c.flops == 2 * 2 * 32 * 32 * 8 * 3


def test_data_dependent_loop_fails_on_meta_with_its_op_named():
    def f(x):
        while x.sum() < 100.0:
            x = x * 1.5
        return x

    with pytest.raises(oc.DataDependentError, match=r"aten\.\w+"):
        _count(f, meta(8))
    # on real tensors every trip runs, and is counted: nothing is a floor
    w = torch.eye(4)

    def g(x):
        trips = 0
        while float(x.sum()) < 100.0:
            x = (x @ w) * 1.5
            trips += 1
        return trips

    trips, c = _count(g, torch.ones(2, 4))
    assert trips == 7 and c.flops == 2 * 2 * 4 * 4 * trips
    assert c.memo_hits == 0          # real tensors are never memoised


def test_fixed_trip_loop():
    def f(x):
        eye = torch.eye(16, dtype=x.dtype, device=x.device)
        for _ in range(17):
            x = torch.tanh(x @ eye)
        return x

    _, c = _count(f, meta(4, 16))
    assert c.flops == 2 * 4 * 16 * 16 * 17


def test_breakdown_names_the_ops():
    x = meta(8, 8)
    _, c = _count(lambda x: (x @ x.T).sum(), x)
    assert c.by_op[aten.mm][1] == 2 * 8 * 8 * 8
    text = c.breakdown()
    assert text.startswith("total flops=1.024e+03")
    assert "aten.mm (1)" in text and "-- top bytes --" in text


# ---- bytes on hand-made programs ----------------------------------------


def _op_bytes(c, op):
    return c.by_op[op][2]


def test_bytes_of_a_product():
    _, c = _count(lambda a, b: a @ b, meta(4, 8), meta(8, 16))
    assert c.bytes == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    assert c.flops == 2 * 4 * 16 * 8


def test_a_folded_3d_product_costs_what_its_2d_product_does():
    # matmul folds (2, 4, 8) @ (8, 16) into view, mm, _unsafe_view
    _, c = _count(lambda a, b: a @ b, meta(2, 4, 8), meta(8, 16))
    _, c2 = _count(lambda a, b: a @ b, meta(8, 8), meta(8, 16))
    assert c.by_op[aten._unsafe_view][0] == 1
    assert _op_bytes(c, aten._unsafe_view) == 0
    assert (c.bytes, c.flops) == (c2.bytes, c2.flops) \
        == (4 * (8 * 8 + 8 * 16 + 8 * 16), 2 * 8 * 16 * 8)


def test_a_reshape_of_a_strided_tensor_costs_its_copy():
    # reshape of a transpose: a clone (read and write), then _unsafe_view
    _, c = _count(lambda x: x.transpose(0, 1).reshape(-1), meta(4, 8))
    assert _op_bytes(c, aten._unsafe_view) == 0
    assert c.bytes == _op_bytes(c, aten.clone) == 2 * 4 * 8 * 4


def test_a_slice_of_a_stacked_weight_reads_only_the_slice():
    stack = meta(6, 8, 16)
    _, c = _count(lambda x, w: x @ w[2], meta(4, 8), stack)
    assert _op_bytes(c, aten.select) == 0
    assert c.bytes == 4 * (4 * 8 + 8 * 16 + 4 * 16)


def test_scatter_and_slice_writes_count_twice_the_update():
    def f(buf, idx, upd, y):
        buf[idx] = upd
        buf[2:4] = y
        return buf

    _, c = _count(f, meta(100, 8), torch.empty(10, dtype=torch.int64,
                                                 device="meta"),
                    meta(10, 8), meta(2, 8))
    assert _op_bytes(c, aten.index_put_) == 2 * 10 * 8 * 4
    assert _op_bytes(c, aten.copy_) == 2 * 2 * 8 * 4
    assert c.bytes == 2 * 10 * 8 * 4 + 2 * 2 * 8 * 4


def test_a_chain_of_views_costs_nothing_and_a_broadcast_reads_once():
    def f(x):
        v = x.view(32, 16).transpose(0, 1).unsqueeze(0).expand(3, 16, 32)
        return v[..., :8].sum()

    _, c = _count(f, meta(4, 8, 16))
    views = [aten.view, aten.transpose, aten.unsqueeze, aten.expand,
             aten.slice]
    assert all(_op_bytes(c, op) == 0 for op in views)
    assert c.bytes == 16 * 8 * 4 + 4        # the sum: distinct inputs + out


def test_gathers_count_twice_what_they_touch():
    idx = torch.empty(5, dtype=torch.int64, device="meta")
    _, c = _count(lambda t, i: t.index_select(0, i), meta(100, 8), idx)
    assert c.bytes == 2 * 5 * 8 * 4


# ---- the memo -------------------------------------------------------------


def _train_trace(cfg, memo):
    p = M.param_shapes(cfg)
    for leaf in tree_flatten(p)[0]:
        leaf.requires_grad_(True)
    batch = M._batch_specs(cfg, B, S, train=True)
    with oc.OpCosts(memo=memo) as c:
        M.loss_fn(cfg, p, batch)[0].backward()
    return c


def _prefill_trace(cfg, memo):
    p = M.param_shapes(cfg)
    batch = M._batch_specs(cfg, B, S, train=False)
    with oc.OpCosts(memo=memo) as c:
        logits, cache = M.prefill(cfg, p, batch, cache_len=S)
    return c, [(tuple(t.shape), t.stride(), t.dtype)
               for t in [logits] + tree_flatten(cache)[0]]


@pytest.mark.parametrize("arch", ["qwen3-8b", "hymba-1.5b", "xlstm-1.3b"])
def test_memo_changes_no_count(arch):
    cfg = ALL[arch].reduced()
    _prefill_trace(cfg, True)            # warm the model's own caches
    (a, out_a), (b, out_b) = _prefill_trace(cfg, True), \
        _prefill_trace(cfg, False)
    assert out_a == out_b
    ta, tb = _train_trace(cfg, True), _train_trace(cfg, False)
    for x, y in ((a, b), (ta, tb)):
        assert x.memo_hits > 0 and y.memo_hits == 0
        assert (x.flops, x.bytes, x.ops) == (y.flops, y.bytes, y.ops)
        assert dict(x.by_op) == dict(y.by_op)


# ---- every reduced arch against the reference ----------------------------


class ByK(oc.OpCosts):
    """Also sums the FLOPs of products whose contraction has size 1."""

    def __init__(self):
        super().__init__()
        self.k1 = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flops = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.overloadpacket in (aten.mm, aten.bmm) and \
                args[0].shape[-1] == 1:
            self.k1 += self.flops - flops
        return out


def _port_flops(cfg, program):
    p = M.param_shapes(cfg)
    if program == "gradient":
        for leaf in tree_flatten(p)[0]:
            leaf.requires_grad_(True)
    with ByK() as c:
        if program in ("forward", "gradient"):
            loss = M.loss_fn(cfg, p, M._batch_specs(cfg, B, S, train=True))[0]
            if program == "gradient":
                loss.backward()
        elif program == "prefill":
            M.prefill(cfg, p, M._batch_specs(cfg, B, S, train=False),
                      cache_len=S)
        else:
            M.decode_step(cfg, p, M.init_cache(cfg, B, S, device="meta"),
                          meta(B, 1, dtype=torch.int32), S - 1)
    return c


_REF = collections.defaultdict(dict)


def _reference(arch, program):
    if program not in _REF[arch]:
        cfg = REF_ALL[arch].reduced()
        p = jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))
        b = jax.eval_shape(lambda: RM.synth_batch(cfg, B, S,
                                                  jax.random.PRNGKey(1)))

        def loss(p, b):
            return RM.loss_fn(cfg, p, b)[0]

        if program == "forward":
            fn, args = loss, (p, b)
        elif program == "gradient":
            fn, args = jax.grad(loss), (p, b)
        elif program == "prefill":
            fn = lambda p, b: RM.prefill(cfg, p, b, cache_len=S)  # noqa
            args = (p, {k: v for k, v in b.items() if k != "labels"})
        else:
            c = jax.eval_shape(lambda: RM.init_cache(cfg, B, S))
            fn = lambda p, c, t, q: RM.decode_step(cfg, p, c, t, q)  # noqa
            args = (p, c, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                    jax.ShapeDtypeStruct((), jnp.int32))
        _REF[arch][program] = _ref_flops(fn, *args)["flops"]
    return _REF[arch][program]


def _xlstm_carry_products(cfg):
    """FLOPs of the first chunk's (mLSTM) and step's (sLSTM) products that
    only feed the gradient of the zero initial carry, per layer: three
    (B·H, L, dqk)×(dqk, dv)-sized products and one matrix-vector product
    of the chunk's normaliser (mLSTM), and the recurrent input's product
    of the four gates (sLSTM)."""
    n_super = cfg.n_layers // cfg.slstm_every
    n_m = cfg.slstm_every - 1
    H, d = cfg.n_heads, cfg.d_model
    dqk, dv, L = d // H, 2 * d // H, cfg.ssm_chunk
    mlstm = 3 * 2 * B * H * L * dqk * dv + 2 * B * H * L * dqk
    slstm = 2 * H * B * (d // H) * 4 * (d // H)
    return n_super * (n_m * mlstm + slstm)


def _k1_products(cfg):
    """The gradient's K = 1 products: hymba's readout ``einsum("bldn,bln->
    bld", hs, C)`` back to ``hs`` is a (B·L, e, 1)×(B·L, 1, N) product a
    chunk, e = d_model, in each layer; the mLSTM normaliser ``einsum(
    "blhk,bhk->blh", qs, n)`` back to ``qs`` is a (B·H, L, 1)×(B·H, 1,
    dqk) product a chunk, H·dqk = d_model, in each mLSTM layer. Over the
    S / L chunks, 2·B·S·e·N and 2·B·S·d_model a layer."""
    if cfg.block == "hymba":
        return cfg.n_layers * 2 * B * S * cfg.d_model * cfg.ssm_state
    n_mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
    return n_mlstm * 2 * B * S * cfg.d_model


def _cse_products(cfg):
    """whisper: the cross-attention K and V projections of the encoder
    output, once more a decoder layer."""
    from repro_torch.models import encdec
    enc = encdec.enc_seq_len(S)
    return cfg.n_layers * 2 * (2 * B * enc * cfg.d_model
                               * cfg.n_kv_heads * cfg.hd)


# (arch, program) → the pinned causes; every other pair is equal
PINNED = {("hymba-1.5b", "gradient"): ("k1",),
          ("xlstm-1.3b", "gradient"): ("k1", "carry"),
          ("whisper-large-v3", "prefill"): ("cse",)}


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("arch", sorted(ALL))
def test_dot_flops_equal_the_references(arch, program):
    cfg = ALL[arch].reduced()
    c = _port_flops(cfg, program)
    ref = _reference(arch, program)
    causes = PINNED.get((arch, program), ())
    expect = ref
    if "k1" in causes:
        assert c.k1 == _k1_products(cfg) > 0
        expect += c.k1
    else:
        assert c.k1 == 0
    if "carry" in causes:
        expect -= _xlstm_carry_products(cfg)
    if "cse" in causes:
        expect += _cse_products(cfg)
    assert c.flops == expect, (c.flops, ref, causes)
    if causes:
        assert c.flops != ref
