"""repro_torch's LM layers (``models/layers.py``, ``ring_cache_from_kv``) on
the CPU against the JAX reference's (``repro.models.layers``,
``repro.models.transformer.ring_cache_from_kv``) on the same seeded numpy
inputs: float outputs in f32 within rtol 2e-4, atol 2e-5 (the reference's
own MoE bar, ``tests/test_moe.py``), integer outputs and shapes bitwise.

Attention: full causal, non-causal (cross, S_kv ≠ S) and sliding-window,
with S not a multiple of the chunk and GQA groups of 1, 2 and 4;
``decode_attention`` with empty slots and ring slots."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def close(ref, port):
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape == port.shape and ref.dtype == port.dtype
    np.testing.assert_allclose(port, ref, rtol=2e-4, atol=2e-5)


def same(ref, port):
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape == port.shape
    np.testing.assert_array_equal(port, ref)


def both(*arrays):
    """Each numpy array as (jnp array, torch tensor)."""
    return [(jnp.asarray(a), torch.from_numpy(a)) for a in arrays]


def test_norms_match_reference():
    rng = _rng(0)
    x, w, b = _normal(rng, 3, 7, 16), _normal(rng, 16), _normal(rng, 16)
    (xj, xt), (wj, wt), (bj, bt) = both(x, w, b)
    close(jl.rms_norm(xj, wj, 1e-5), tl.rms_norm(xt, wt, 1e-5))
    close(jl.layer_norm(xj, wj, bj, 1e-6), tl.layer_norm(xt, wt, bt, 1e-6))
    # an offset mean: the population variance, not the sample one
    (x2j, x2t), = both(x + 3.0)
    close(jl.layer_norm(x2j, wj, bj), tl.layer_norm(x2t, wt, bt))


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (128, 1e6), (80, 1e4)])
def test_rope_matches_reference(hd, theta):
    rng = _rng(hd)
    np.testing.assert_array_equal(tl.rope_freqs(hd, theta),
                                  jl.rope_freqs(hd, theta))
    x = _normal(rng, 2, 6, 3, hd)
    pos = rng.integers(0, 4_000, (2, 6)).astype(np.int32)
    (xj, xt), (pj, pt) = both(x, pos)
    close(jl.apply_rope(xj, pj, theta), tl.apply_rope(xt, pt, theta))


@pytest.mark.parametrize("hd", [16, 128, 80])
def test_mrope_matches_reference(hd):
    rng = _rng(hd + 1)
    x = _normal(rng, 2, 6, 3, hd)
    pos3 = rng.integers(0, 500, (2, 6, 3)).astype(np.int32)  # 3 streams
    (xj, xt), (pj, pt) = both(x, pos3)
    close(jl.apply_mrope(xj, pj, 1e6), tl.apply_mrope(xt, pt, 1e6))


# (S, S_kv, H, KV, causal, window, q_chunk, kv_chunk)
ATTN = [
    (40, 40, 4, 4, True, 0, 16, 16),     # G = 1, S not a chunk multiple
    (40, 40, 4, 2, True, 0, 16, 8),      # G = 2
    (33, 33, 8, 2, True, 0, 16, 16),     # G = 4
    (24, 40, 4, 4, False, 0, 16, 16),    # cross attention, S_kv ≠ S
    (12, 20, 4, 2, False, 0, 16, 16),    # chunks wider than S
    (70, 70, 4, 2, True, 16, 16, 16),    # sliding window, ragged S
    (64, 64, 8, 2, True, 32, 8, 16),     # sliding window, G = 4
    (20, 20, 4, 4, True, 32, 16, 16),    # window ≥ S: the causal path
]


@pytest.mark.parametrize("S,S_kv,H,KV,causal,window,q_chunk,kv_chunk", ATTN)
def test_attention_matches_reference(S, S_kv, H, KV, causal, window,
                                     q_chunk, kv_chunk):
    rng = _rng(S * 100 + S_kv + H)
    hd = 16
    q = _normal(rng, 2, S, H, hd)
    k = _normal(rng, 2, S_kv, KV, hd)
    v = _normal(rng, 2, S_kv, KV, hd)
    (qj, qt), (kj, kt), (vj, vt) = both(q, k, v)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    close(jl.attention(qj, kj, vj, **kw), tl.attention(qt, kt, vt, **kw))


def test_attention_groups_query_heads_by_kv_head():
    """Head h reads KV head h // G: with one KV head holding the values,
    the grouping that a ``repeat`` in the other order would give differs."""
    rng = _rng(5)
    q = _normal(rng, 1, 8, 4, 16)
    k = _normal(rng, 1, 8, 2, 16)
    v = np.zeros((1, 8, 2, 16), np.float32)
    v[:, :, 1] = 1.0
    out = tl.attention(*map(torch.from_numpy, (q, k, v)), q_chunk=4,
                       kv_chunk=4)
    assert torch.all(out[:, :, :2] == 0) and torch.allclose(
        out[:, :, 2:], torch.ones(1, 8, 2, 16))


@pytest.mark.parametrize("case", ["empty", "ring", "window"])
def test_decode_attention_matches_reference(case):
    rng = _rng({"empty": 1, "ring": 2, "window": 3}[case])
    B, T, H, KV, hd = 2, 12, 4, 2, 16
    q = _normal(rng, B, 1, H, hd)
    kc = _normal(rng, B, T, KV, hd)
    vc = _normal(rng, B, T, KV, hd)
    if case == "empty":              # the first 7 slots filled, rest empty
        slot_pos = np.where(np.arange(T) < 7, np.arange(T), -1)
        pos, window = 6, 0
    else:                            # a ring holding positions 13..24
        slot_pos = 13 + (np.arange(T) - 13) % T
        pos, window = 24, (T if case == "ring" else 5)
    slot_pos = np.broadcast_to(slot_pos, (B, T)).astype(np.int32)
    posv = np.full((B,), pos, np.int32)
    (qj, qt), (kj, kt), (vj, vt), (sj, st), (pj, pt) = both(
        q, kc, vc, np.ascontiguousarray(slot_pos), posv)
    close(jl.decode_attention(qj, kj, vj, sj, pj, window=window),
          tl.decode_attention(qt, kt, vt, st, pt, window=window))


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = _rng(7)
    x = _normal(rng, 2, 5, 16)
    p = {"w1": _normal(rng, 16, 32, scale=0.3),
         "w3": _normal(rng, 16, 32, scale=0.3),
         "w2": _normal(rng, 32, 16, scale=0.3)}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    close(jl.mlp(jnp.asarray(x), pj, act), tl.mlp(torch.from_numpy(x), pt,
                                                  act))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    close(jax.nn.gelu(jnp.asarray(x)), tl.gelu(torch.from_numpy(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((exact - tl.gelu(torch.from_numpy(x))).abs().max()) > 1e-4


def test_embed_unembed_and_cross_entropy_match_reference():
    rng = _rng(9)
    table = _normal(rng, 11, 16, scale=0.5)
    tokens = rng.integers(0, 11, (2, 5)).astype(np.int32)
    (tj, ttab), (kj, kt) = both(table, tokens)
    xj, xt = jl.embed(kj, tj, jnp.float32), tl.embed(kt, ttab, torch.float32)
    same(xj, xt)
    logits = _normal(rng, 2, 5, 11, scale=3.0)
    (lj, lt), = both(logits)
    close(jl.unembed(xj, tj), tl.unembed(xt, ttab))
    close(jl.cross_entropy(lj, kj), tl.cross_entropy(lt, kt))
    mask = (rng.random((2, 5)) < 0.6).astype(np.int32)
    (mj, mt), = both(mask)
    close(jl.cross_entropy(lj, kj, mj), tl.cross_entropy(lt, kt, mt))
    zero = np.zeros((2, 5), np.int32)
    close(jl.cross_entropy(lj, kj, jnp.asarray(zero)),
          tl.cross_entropy(lt, kt, torch.from_numpy(zero)))


@pytest.mark.parametrize("S,T", [(10, 16), (10, 10), (10, 4), (13, 5)])
def test_ring_cache_from_kv_matches_reference(S, T):
    rng = _rng(S + T)
    k, v = _normal(rng, 2, S, 2, 4), _normal(rng, 2, S, 2, 4)
    (kj, kt), (vj, vt) = both(k, v)
    for r, p in zip(jt.ring_cache_from_kv(kj, vj, T),
                    tt.ring_cache_from_kv(kt, vt, T)):
        assert np.asarray(r).dtype == p.numpy().dtype
        same(r, p)


def test_cache_slot_is_the_reference_clamp():
    """``dynamic_update_slice`` clamps the start into the cache: a write at
    pos ≥ T lands in slot T - 1; a ring (window) writes at pos % T."""
    for T in (1, 4, 7):
        cache = jnp.zeros((1, T), jnp.int32)
        for pos in range(3 * T):
            out = jax.lax.dynamic_update_slice_in_dim(
                cache, jnp.full((1, 1), pos + 1, jnp.int32), jnp.int32(pos),
                axis=1)
            assert tt.cache_slot(pos, T, 0) == int(jnp.argmax(out == pos + 1))
            assert tt.cache_slot(pos, T, T) == pos % T
