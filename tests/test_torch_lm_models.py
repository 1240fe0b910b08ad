"""repro_torch's LM serving path (``configs/``, ``models/``) on the CPU
against the JAX reference's (``repro.configs``, ``repro.models``), for all
ten architectures at their reduced size.

The reference's parameters (``init_params`` at key 0) are carried across
with ``params_from_jax``, and the same seeded numpy inputs go through both
packages, the reference op by op as its own tests run it: ``forward``
logits and aux, a 56-token ``prefill``'s logits and every cache leaf, and
4 ``decode_step``s' logits and caches. Floats in f32 within rtol 2e-4,
atol 2e-5 (``tests/test_moe.py``'s bar); integer leaves (``slot_pos``,
``x_pos``), shapes and dtypes bitwise. Each arch's reference run is made
once per module. Also: ``LM``, ``params_from_jax``'s checks, and the
reference's decode clamp at pos ≥ T (ROADMAP §3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM

ARCHS = sorted(jconfigs.ALL)
B, S, PRE, STEPS = 2, 64, 56, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(ref, port, what=""):
    ref = np.asarray(ref)
    port = port.numpy()
    assert ref.shape == port.shape and ref.dtype == port.dtype, what
    if ref.dtype.kind in "iu":
        np.testing.assert_array_equal(port, ref, err_msg=what)
    else:
        np.testing.assert_allclose(port, ref, rtol=2e-4, atol=2e-5,
                                   err_msg=what)


def inputs(cfg):
    """The seeded numpy batch of one arch (B × S tokens)."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (0.02 * rng.standard_normal(
            (B, max(S // 4, 8), cfg.d_model))).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["pos3"] = np.stack([pos, pos, pos], -1)
    if cfg.block == "encdec":
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, max(S // 4, 8), cfg.d_model))).astype(np.float32)
    return batch


def prompt(batch, n):
    out = dict(batch, tokens=batch["tokens"][:, :n])
    if "pos3" in out:
        out["pos3"] = batch["pos3"][:, :n]
    return out


_REF = {}


def reference(name):
    """The reference's run of one reduced arch, numpy out (made once)."""
    if name in _REF:
        return _REF[name]
    cfg = jconfigs.ALL[name].reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    batch = inputs(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _, aux = JM.forward(cfg, params, jb)
    lg, cache = JM.prefill(cfg, params, prompt(jb, PRE), cache_len=S)
    prefilled = (np.asarray(lg), jax.tree.map(np.asarray, cache))
    steps = []
    for t in range(PRE, PRE + STEPS):
        out, cache = JM.decode_step(cfg, params, cache,
                                    jb["tokens"][:, t:t + 1], jnp.int32(t))
        steps.append((np.asarray(out), jax.tree.map(np.asarray, cache)))
    _REF[name] = dict(
        params=jax.tree.map(np.asarray, params), batch=batch,
        logits=np.asarray(logits), aux=np.asarray(aux),
        prefill=prefilled, steps=steps)
    return _REF[name]


def port(name):
    cfg = tconfigs.ALL[name].reduced()
    ref = reference(name)
    params = TM.params_from_jax(cfg, ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return cfg, params, batch, ref


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    cfg, params, batch, ref = port(name)
    logits, cache, aux = TM.forward(cfg, params, batch)
    assert cache is None
    close(ref["logits"], logits, "logits")
    close(ref["aux"], aux, "aux")
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_matches_reference(name):
    cfg, params, batch, ref = port(name)
    lg, cache = TM.prefill(cfg, params, prompt(batch, PRE), cache_len=S)
    close(ref["prefill"][0], lg, "logits")
    assert set(cache) == set(ref["prefill"][1])
    for k, v in ref["prefill"][1].items():
        close(v, cache[k], k)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_reference(name):
    cfg, params, batch, ref = port(name)
    _, cache = TM.prefill(cfg, params, prompt(batch, PRE), cache_len=S)
    for j, t in enumerate(range(PRE, PRE + STEPS)):
        out, cache = TM.decode_step(cfg, params, cache,
                                    batch["tokens"][:, t:t + 1], t)
        ref_out, ref_cache = ref["steps"][j]
        close(ref_out, out, f"step {t} logits")
        assert set(cache) == set(ref_cache)
        for k, v in ref_cache.items():
            close(v, cache[k], f"step {t} {k}")


def test_lm_module_serves_as_the_functions():
    cfg, params, batch, ref = port("qwen3-8b")
    lm = TM.LM(cfg, params)
    assert not any(p.requires_grad for p in lm.parameters())
    assert "blocks/attn/wq" in dict(lm.named_parameters())
    assert lm.device == torch.device("cpu")
    close(ref["logits"], lm(batch)[0])
    lg, cache = lm.prefill(prompt(batch, PRE), S)
    close(ref["prefill"][0], lg)
    out, cache = lm.decode_step(cache, batch["tokens"][:, PRE:PRE + 1], PRE)
    close(ref["steps"][0][0], out)
    empty = lm.init_cache(B, S)
    assert empty["k"].shape == cache["k"].shape


def test_decode_clamps_a_write_past_the_cache_as_the_reference():
    """The reference's fault (ROADMAP §3): decode at pos ≥ T (no window)
    writes slot T - 1, over position T - 1, because
    ``lax.dynamic_update_slice`` clamps its start. Smallest input: reduced
    qwen3-8b, cache_len 4, decoded at pos 4. The port keeps the clamp."""
    cfg = jconfigs.ALL["qwen3-8b"].reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 5)).astype(np.int32)
    _, jc = JM.prefill(cfg, params, {"tokens": jnp.asarray(tokens[:, :4])},
                       cache_len=4)
    jout, jc = JM.decode_step(cfg, params, jc, jnp.asarray(tokens[:, 4:]),
                              jnp.int32(4))
    assert np.asarray(jc["slot_pos"])[0, 0].tolist() == [0, 1, 2, 4]

    tcfg = tconfigs.ALL["qwen3-8b"].reduced()
    tp = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    _, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(tokens[:, :4])},
                       cache_len=4)
    k3 = tc["k"][:, :, 3].clone()
    tout, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(tokens[:, 4:]),
                              4)
    assert tc["slot_pos"][0, 0].tolist() == [0, 1, 2, 4]
    assert not torch.equal(tc["k"][:, :, 3], k3)   # position 3 is gone
    close(jout, tout)
    for k, v in jc.items():
        close(v, tc[k], k)


def test_params_from_jax_checks_keys_shapes_and_dtypes():
    cfg = tconfigs.ALL["qwen3-8b"].reduced()
    ref = reference("qwen3-8b")["params"]
    TM.params_from_jax(cfg, ref, device="cpu")
    bad = dict(ref, lm_head=ref["lm_head"][:, :8])
    with pytest.raises(ValueError, match="lm_head"):
        TM.params_from_jax(cfg, bad, device="cpu")
    bad = dict(ref, embed=ref["embed"].astype(np.float64))
    with pytest.raises(ValueError, match="embed"):
        TM.params_from_jax(cfg, bad, device="cpu")
    bad = {k: v for k, v in ref.items() if k != "out_norm_w"}
    with pytest.raises(ValueError, match="out_norm_w"):
        TM.params_from_jax(cfg, bad, device="cpu")
    blocks = {k: v for k, v in ref["blocks"].items() if k != "ffn"}
    with pytest.raises(ValueError, match="blocks"):
        TM.params_from_jax(cfg, dict(ref, blocks=blocks), device="cpu")
