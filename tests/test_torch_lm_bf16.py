"""repro_torch's LM serving path in bf16, the compute dtype of every
config, on the CPU against the JAX reference in bf16 on the same weights
and inputs (the f32 files hold the same functions at rtol 2e-4, atol 2e-5).

Two implementations that round at different places differ in bf16 by
about as much as bf16 differs from f32, so the bars are set from the
reference's own rounding:

* the ops whose bf16 result the reference rounds once (the norms, the
  attention's probability tile and output, the f32-accumulated unembed,
  the selective scan): the port rounds at the same places, so few
  elements differ, by at most one bf16 unit in the last place of the
  output's largest magnitude (a norm computed in bf16, a probability tile
  kept in f32 or a bf16 unembed each break this);
* each reduced arch whole: ``test_torch_lm_bf16_archs.py``;
* hymba-1.5b at its full width (depth 2, 128 tokens): the port's bf16
  forward is about as far from the reference's f32 forward as the
  reference's own bf16 forward is, so hymba's large bf16 distance on the
  card is the architecture's numerics, not the port's (PERF.md §5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jl
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


def rel(ref, port) -> float:
    """max |port - ref| over max |ref|."""
    ref, port = _f32(ref), _f32(port)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def ulp_rel(ref) -> float:
    """One bf16 unit in the last place of max |ref|, over max |ref|."""
    m = float(np.abs(_f32(ref)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) / m


def rounded_once(ref, port, frac: float):
    """bf16 outputs of the same dtype and shape: at most ``frac`` of the
    elements differ, each by at most one bf16 unit in the last place of
    max |ref|."""
    assert str(ref.dtype) == "bfloat16" and port.dtype == torch.bfloat16
    assert tuple(ref.shape) == tuple(port.shape)
    r, p = _f32(ref), _f32(port)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
    d = np.abs(p - r)
    assert d.max() <= ulp and (d > 0).mean() <= frac, \
        (d.max() / ulp, (d > 0).mean())


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def both16(*arrays):
    """Each f32 numpy array as (jnp, torch) bf16 arrays."""
    return [(jnp.asarray(a).astype(jnp.bfloat16),
             torch.from_numpy(a).to(torch.bfloat16)) for a in arrays]


# ------------------------------------------------------- rounded-once ops --


def test_bf16_norms_are_the_reference_bitwise():
    rng = _rng(0)
    x = _normal(rng, 3, 40, 64)
    w, b = 1.0 + _normal(rng, 64, scale=0.3), _normal(rng, 64, scale=0.3)
    (xj, xt), = both16(x + 0.5)
    wj, wt, bj, bt = jnp.asarray(w), torch.from_numpy(w), \
        jnp.asarray(b), torch.from_numpy(b)
    rounded_once(jl.rms_norm(xj, wj), tl.rms_norm(xt, wt), 0.0)
    rounded_once(jl.layer_norm(xj, wj, bj), tl.layer_norm(xt, wt, bt), 0.0)


ATTN16 = [  # S, H, KV, causal, window, q_chunk, kv_chunk
    (40, 8, 2, True, 0, 16, 16),      # GQA 4, ragged S
    (40, 4, 4, False, 0, 16, 16),     # non-causal, G = 1
    (70, 4, 2, True, 16, 16, 16),     # sliding window, ragged S
]


@pytest.mark.parametrize("S_,H,KV,causal,window,q_chunk,kv_chunk", ATTN16)
def test_bf16_attention_rounds_as_the_reference(S_, H, KV, causal, window,
                                                q_chunk, kv_chunk):
    rng = _rng(S_ + H + KV)
    q, k, v = (_normal(rng, 2, S_, n, 16) for n in (H, KV, KV))
    (qj, qt), (kj, kt), (vj, vt) = both16(q, k, v)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              kv_chunk=kv_chunk)
    rounded_once(jl.attention(qj, kj, vj, **kw),
                 tl.attention(qt, kt, vt, **kw), 0.01)


def test_bf16_decode_attention_rounds_as_the_reference():
    rng = _rng(7)
    T = 24
    q, kc, vc = _normal(rng, 2, 1, 8, 16), _normal(rng, 2, T, 2, 16), \
        _normal(rng, 2, T, 2, 16)
    slot_pos = np.broadcast_to(np.where(np.arange(T) < 17, np.arange(T), -1),
                               (2, T)).astype(np.int32).copy()
    pos = np.full((2,), 16, np.int32)
    (qj, qt), (kj, kt), (vj, vt) = both16(q, kc, vc)
    rounded_once(
        jl.decode_attention(qj, kj, vj, jnp.asarray(slot_pos),
                            jnp.asarray(pos)),
        tl.decode_attention(qt, kt, vt, torch.from_numpy(slot_pos),
                            torch.from_numpy(pos)), 0.01)


def test_bf16_unembed_accumulates_in_f32():
    rng = _rng(8)
    (xj, xt), = both16(_normal(rng, 2, 9, 64))
    table = _normal(rng, 100, 64, scale=0.5)
    ref = np.asarray(jl.unembed(xj, jnp.asarray(table)))
    port = tl.unembed(xt, torch.from_numpy(table))
    assert port.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(port.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_bf16_selective_scan_and_step_round_as_the_reference():
    rng = _rng(9)
    Bsz, S_, d, N = 2, 24, 16, 4
    x, Bt, Ct = _normal(rng, Bsz, S_, d), _normal(rng, Bsz, S_, N), \
        _normal(rng, Bsz, S_, N)
    dt = np.log1p(np.exp(_normal(rng, Bsz, S_, d))).astype(np.float32)
    A_log = np.log(np.arange(1, N + 1, dtype=np.float32))[None].repeat(d, 0)
    D = _normal(rng, d)
    h0 = _normal(rng, Bsz, d, N, scale=0.1)
    (xj, xt), (dj, dtt), (bj, btt), (cj, ct) = both16(x, dt, Bt, Ct)
    yj, hj = jssm.selective_scan(xj, dj, bj, cj, jnp.asarray(A_log),
                                 jnp.asarray(D), chunk=8, h0=jnp.asarray(h0))
    yt, ht = tssm.selective_scan(xt, dtt, btt, ct, torch.from_numpy(A_log),
                                 torch.from_numpy(D), chunk=8,
                                 h0=torch.from_numpy(h0))
    rounded_once(yj, yt, 0.01)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-4,
                               atol=2e-5)
    yj, hj = jssm.selective_step(xj[:, 0], dj[:, 0], bj[:, 0], cj[:, 0],
                                 jnp.asarray(A_log), jnp.asarray(D), hj)
    yt, ht = tssm.selective_step(xt[:, 0], dtt[:, 0], btt[:, 0], ct[:, 0],
                                 torch.from_numpy(A_log), torch.from_numpy(D),
                                 ht)
    rounded_once(yj, yt, 0.01)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-4,
                               atol=2e-5)


def test_hymba_bf16_distance_at_full_width_is_the_references():
    """hymba-1.5b at its full width, depth 2, B = 1, 128 tokens: the
    port's bf16 forward logits are within 1.25 times the reference's own
    bf16-vs-f32 distance of both the reference's f32 and its bf16 forward
    (measured 1.13 and 1.05 times)."""
    cfg32 = dataclasses.replace(jconfigs.ALL["hymba-1.5b"], n_layers=2,
                                dtype="float32")
    params = JM.init_params(cfg32, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg32.vocab, (1, 128)).astype(np.int32)

    def ref(cfg):
        return np.asarray(jax.jit(
            lambda p, t: JM.forward(cfg, p, {"tokens": t})[0])(params,
                                                              tokens))
    r32, r16 = ref(cfg32), ref(bf16(cfg32))
    tcfg = bf16(dataclasses.replace(tconfigs.ALL["hymba-1.5b"], n_layers=2))
    tp = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    del params
    p16 = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})[0]
    own = float(np.abs(r16 - r32).max())
    to32 = float(np.abs(p16.numpy() - r32).max())
    to16 = float(np.abs(p16.numpy() - r16).max())
    print(f"hymba-1.5b, depth 2: the reference's bf16 forward {own:.4g} "
          f"from its f32 forward; the port's bf16 forward {to32:.4g} from "
          f"it and {to16:.4g} from the reference's bf16 forward")
    assert to32 <= 1.25 * own
    assert to16 <= 1.25 * own
