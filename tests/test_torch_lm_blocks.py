"""repro_torch's LM blocks (``models/moe.py``, ``ssm.py``, ``xlstm.py``) on
the CPU against the JAX reference's (``repro.models.moe``, ``ssm``,
``xlstm``) on the same seeded numpy inputs: float outputs in f32 within
rtol 2e-4, atol 2e-5 (``tests/test_moe.py``'s bar), routing indices and
shapes bitwise.

MoE at ample and tight capacity (``route``'s top-k indices, ties to the
lower index as ``lax.top_k``, and the capacity's float truncation); the
selective scan and step with a carried state (a ragged S raises); the
mamba head; the chunkwise mLSTM against the reference and against its own
step recurrence unrolled; the mLSTM and sLSTM blocks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def close(ref, port):
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape == port.shape and ref.dtype == port.dtype
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=2e-5)


def pair(tree):
    """A dict of numpy arrays as (jnp dict, torch dict)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


# ------------------------------------------------------------------ MoE ----


def _moe_params(rng, d, f, e, act):
    p = {"router": _normal(rng, d, e, scale=0.5),
         "w1": _normal(rng, e, d, f, scale=0.2),
         "w2": _normal(rng, e, f, d, scale=0.2)}
    if act == "swiglu":
        p["w3"] = _normal(rng, e, d, f, scale=0.2)
    return p


# (B, S, d, f, E, K, capacity_factor, act)
MOE = [(2, 8, 16, 32, 4, 2, 8.0, "swiglu"),     # ample: nothing drops
       (1, 32, 8, 16, 4, 2, 0.5, "swiglu"),     # tight: drops
       (2, 24, 8, 16, 8, 3, 1.25, "gelu"),
       (3, 1, 8, 16, 4, 2, 1.25, "swiglu")]     # a decode step


@pytest.mark.parametrize("B,S,d,f,E,K,cf,act", MOE)
def test_moe_ffn_matches_reference(B, S, d, f, E, K, cf, act):
    rng = np.random.default_rng(S * 10 + E)
    pj, pt = pair(_moe_params(rng, d, f, E, act))
    x = _normal(rng, B, S, d, scale=0.5)
    yj, auxj = jmoe.moe_ffn(jnp.asarray(x), pj, n_experts=E, top_k=K,
                            capacity_factor=cf, act=act)
    yt, auxt = tmoe.moe_ffn(torch.from_numpy(x), pt, n_experts=E, top_k=K,
                            capacity_factor=cf, act=act)
    close(yj, yt)
    close(auxj, auxt)
    # the routing the dispatch saw, bitwise
    logits = (jnp.asarray(x) @ pj["router"]).astype(jnp.float32)
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
    _, tp, te = tmoe.route(torch.from_numpy(x), pt["router"], K)
    np.testing.assert_array_equal(te.numpy(), np.asarray(top_e))
    close(top_p / top_p.sum(-1, keepdims=True), tp)


def test_moe_tight_capacity_drops():
    """At capacity factor 0.5 some entries drop: the output differs from
    the ample one's, and the port and the reference drop the same ones."""
    rng = np.random.default_rng(1)
    pj, pt = pair(_moe_params(rng, 8, 16, 4, "swiglu"))
    x = torch.from_numpy(_normal(rng, 1, 32, 8))
    tight, _ = tmoe.moe_ffn(x, pt, n_experts=4, top_k=2, capacity_factor=0.5)
    ample, _ = tmoe.moe_ffn(x, pt, n_experts=4, top_k=2, capacity_factor=8.0)
    assert tmoe.capacity(32, 4, 2, 0.5) == 8
    dropped = (tight - ample).abs().amax(-1) > 1e-6
    assert 0 < int(dropped.sum()) < 32
    assert float(tight.norm()) <= float(ample.norm()) * 1.01


def test_route_breaks_ties_to_the_lower_index():
    """Equal probabilities: lax.top_k takes the lower expert index first;
    the port's stable descending sort does the same."""
    rng = np.random.default_rng(2)
    router = _normal(rng, 8, 6)
    router[:, 4] = router[:, 1]          # experts 1 and 4 always tie
    router[:, 5] = router[:, 2]          # and 2 and 5
    x = _normal(rng, 2, 16, 8)
    for r in (router, np.zeros_like(router)):   # all six tie
        logits = (jnp.asarray(x) @ jnp.asarray(r)).astype(jnp.float32)
        for K in (1, 2, 3, 6):
            _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), K)
            _, _, te = tmoe.route(torch.from_numpy(x), torch.from_numpy(r), K)
            np.testing.assert_array_equal(te.numpy(), np.asarray(top_e))


def test_capacity_is_the_reference_expression():
    for S in (1, 7, 56, 64, 2_048, 2_080):
        for E, K in ((4, 2), (32, 8), (64, 6), (3, 3)):
            for cf in (0.5, 1.0, 1.25, 8.0):
                ref = min(max(8, int(S * K / E * cf)), S * K)
                assert tmoe.capacity(S, E, K, cf) == ref


# ------------------------------------------------------------------ SSM ----


def _scan_inputs(rng, B, S, d, N):
    x = _normal(rng, B, S, d)
    dt = np.log1p(np.exp(_normal(rng, B, S, d))).astype(np.float32)
    return (x, dt, _normal(rng, B, S, N), _normal(rng, B, S, N),
            np.log(np.arange(1, N + 1, dtype=np.float32))[None].repeat(d, 0)
            + _normal(rng, d, N, scale=0.1), _normal(rng, d))


@pytest.mark.parametrize("S,chunk", [(24, 8), (16, 16), (12, 32)])
def test_selective_scan_matches_reference(S, chunk):
    rng = np.random.default_rng(S + chunk)
    args = _scan_inputs(rng, 2, S, 6, 4)
    h0 = _normal(rng, 2, 6, 4)
    yj, hj = jssm.selective_scan(*map(jnp.asarray, args), chunk=chunk,
                                 h0=jnp.asarray(h0))
    yt, ht = tssm.selective_scan(*map(torch.from_numpy, args), chunk=chunk,
                                 h0=torch.from_numpy(h0))
    close(yj, yt)
    close(hj, ht)
    yj, hj = jssm.selective_scan(*map(jnp.asarray, args), chunk=chunk)
    yt, ht = tssm.selective_scan(*map(torch.from_numpy, args), chunk=chunk)
    close(yj, yt)
    close(hj, ht)


def test_selective_scan_rejects_a_ragged_sequence():
    args = _scan_inputs(np.random.default_rng(3), 1, 20, 4, 2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.selective_scan(*map(torch.from_numpy, args), chunk=8)


def test_selective_step_matches_reference_and_the_scan():
    rng = np.random.default_rng(4)
    x, dt, Bt, Ct, A_log, D = _scan_inputs(rng, 2, 8, 6, 4)
    h0 = _normal(rng, 2, 6, 4)
    hj, ht = jnp.asarray(h0), torch.from_numpy(h0)
    ys = []
    for t in range(8):
        step = [a[:, t] for a in (x, dt, Bt, Ct)] + [A_log, D]
        yj, hj = jssm.selective_step(*map(jnp.asarray, step), hj)
        yt, ht = tssm.selective_step(*map(torch.from_numpy, step), ht)
        close(yj, yt)
        close(hj, ht)
        ys.append(yt)
    ys_scan, h_scan = tssm.selective_scan(
        *map(torch.from_numpy, (x, dt, Bt, Ct, A_log, D)), chunk=4,
        h0=torch.from_numpy(h0))
    torch.testing.assert_close(torch.stack(ys, 1), ys_scan, rtol=2e-4,
                               atol=2e-5)
    torch.testing.assert_close(ht, h_scan, rtol=2e-4, atol=2e-5)


def _mamba_params(rng, d, N):
    return {"w_in": _normal(rng, d, d, scale=0.3),
            "w_gate": _normal(rng, d, d, scale=0.3),
            "w_dt": _normal(rng, d, scale=0.3),
            "dt_bias": _normal(rng, 1),
            "w_B": _normal(rng, d, N, scale=0.3),
            "w_C": _normal(rng, d, N, scale=0.3),
            "A_log": np.log(np.arange(1, N + 1, dtype=np.float32))[None]
            .repeat(d, 0),
            "D": _normal(rng, d),
            "w_out": _normal(rng, d, d, scale=0.3)}


def test_mamba_head_and_step_match_reference():
    rng = np.random.default_rng(5)
    pj, pt = pair(_mamba_params(rng, 8, 4))
    x = _normal(rng, 2, 16, 8)
    yj, hj = jssm.mamba_head(jnp.asarray(x), pj, state=4, chunk=8)
    yt, ht = tssm.mamba_head(torch.from_numpy(x), pt, state=4, chunk=8)
    close(yj, yt)
    close(hj, ht)
    x1 = _normal(rng, 2, 1, 8)
    yj, hj = jssm.mamba_head_step(jnp.asarray(x1), pj, hj)
    yt, ht = tssm.mamba_head_step(torch.from_numpy(x1), pt, ht)
    close(yj, yt)
    close(hj, ht)


# ---------------------------------------------------------------- xLSTM ----


def _mlstm_inputs(rng, B, S, H, dk, dv):
    q, k = _normal(rng, B, S, H, dk), _normal(rng, B, S, H, dk)
    v = _normal(rng, B, S, H, dv)
    i = (1 / (1 + np.exp(-_normal(rng, B, S, H)))).astype(np.float32)
    lf = -np.log1p(np.exp(-(3.0 + _normal(rng, B, S, H)))).astype(np.float32)
    return q, k, v, i, lf


def test_mlstm_chunkwise_matches_reference_and_its_step():
    rng = np.random.default_rng(6)
    B, S, H, dk, dv = 2, 24, 2, 4, 8
    args = _mlstm_inputs(rng, B, S, H, dk, dv)
    carry = (_normal(rng, B, H, dk, dv), np.abs(_normal(rng, B, H, dk)))
    yj, (Cj, nj) = jxl.mlstm_chunkwise(*map(jnp.asarray, args), chunk=8,
                                       carry=tuple(map(jnp.asarray, carry)))
    tc = tuple(map(torch.from_numpy, carry))
    yt, (Ct, nt) = txl.mlstm_chunkwise(*map(torch.from_numpy, args), chunk=8,
                                       carry=tc)
    close(yj, yt)
    close(Cj, Ct)
    close(nj, nt)
    # the same sequence through the one-step recurrence, unrolled
    st, ys = tc, []
    for t in range(S):
        y, st = txl.mlstm_step(*[torch.from_numpy(a[:, t]) for a in args], st)
        ys.append(y)
    for a, b in ((torch.stack(ys, 1), yt), (st[0], Ct), (st[1], nt)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        txl.mlstm_chunkwise(*[torch.from_numpy(a[:, :20]) for a in args],
                            chunk=8)


def _mlstm_params(rng, d, H):
    e = 2 * d
    return {"w_up": _normal(rng, d, 2 * e, scale=0.3),
            "w_q": _normal(rng, e, d, scale=0.3),
            "w_k": _normal(rng, e, d, scale=0.3),
            "w_i": _normal(rng, d, H, scale=0.3),
            "b_i": np.zeros(H, np.float32),
            "w_f": _normal(rng, d, H, scale=0.3),
            "b_f": np.full(H, 3.0, np.float32),
            "w_down": _normal(rng, e, d, scale=0.3)}


def test_mlstm_block_matches_reference():
    rng = np.random.default_rng(7)
    d, H = 16, 4
    pj, pt = pair(_mlstm_params(rng, d, H))
    x = _normal(rng, 2, 16, d)
    yj, cj = jxl.mlstm_block(jnp.asarray(x), pj, n_heads=H, chunk=8)
    yt, ct = txl.mlstm_block(torch.from_numpy(x), pt, n_heads=H, chunk=8)
    close(yj, yt)
    x1 = _normal(rng, 2, 1, d)
    yj, cj = jxl.mlstm_block(jnp.asarray(x1), pj, n_heads=H, chunk=8,
                             carry=cj, step=True)
    yt, ct = txl.mlstm_block(torch.from_numpy(x1), pt, n_heads=H, chunk=8,
                             carry=ct, step=True)
    close(yj, yt)
    for a, b in zip(cj, ct):
        close(a, b)


def test_slstm_block_matches_reference():
    rng = np.random.default_rng(8)
    d, H = 16, 4
    dh = d // H
    p = {"w_x": _normal(rng, d, 4 * d, scale=0.3),
         "r": _normal(rng, H, dh, 4 * dh, scale=0.3),
         "b": _normal(rng, 4 * d, scale=0.3),
         "w_out": _normal(rng, d, d, scale=0.3)}
    pj, pt = pair(p)
    x = _normal(rng, 2, 12, d)
    yj, cj = jxl.slstm_block(jnp.asarray(x), pj, n_heads=H)
    yt, ct = txl.slstm_block(torch.from_numpy(x), pt, n_heads=H)
    close(yj, yt)
    for a, b in zip(cj, ct):
        close(a, b)
    x1 = _normal(rng, 2, 1, d)
    yj, cj = jxl.slstm_block(jnp.asarray(x1), pj, n_heads=H, carry=cj,
                             step=True)
    yt, ct = txl.slstm_block(torch.from_numpy(x1), pt, n_heads=H, carry=ct,
                             step=True)
    close(yj, yt)
    for a, b in zip(cj, ct):
        close(a, b)
