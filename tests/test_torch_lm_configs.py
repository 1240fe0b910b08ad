"""repro_torch's LM configs and model declarations (``configs/``,
``models/model.py``) on the CPU against the JAX reference's
(``repro.configs``, ``repro.models``), for all ten architectures: every
config field by field at full and reduced size (``ALL``, ``reduced()``,
``param_count``, ``active_param_count``, ``shape_applicable``,
``SHAPES``), the ``model_defs`` trees (keys, shapes, logical axes, init
kinds) and ``param_axes``/``param_shapes``, ``input_specs`` of every
(arch, shape) cell (meta tensors of the reference's shapes and dtypes),
``model_flops``, ``init_params``' init kinds, and ``synth_batch``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

ARCHS = sorted(jconfigs.ALL)
JDTYPE = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


def test_configs_equal_the_reference():
    assert list(tconfigs.ALL) == list(jconfigs.ALL)
    fields = [f.name for f in dataclasses.fields(jconfigs.ArchConfig)]
    assert [f.name for f in dataclasses.fields(tconfigs.ArchConfig)] == fields
    for name, jc in jconfigs.ALL.items():
        tc = tconfigs.get(name)
        for c_j, c_t in ((jc, tc), (jc.reduced(), tc.reduced())):
            assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j), name
            assert (c_t.hd, c_t.is_moe) == (c_j.hd, c_j.is_moe)
            assert c_t.param_count() == c_j.param_count()
            assert c_t.active_param_count() == c_j.active_param_count()
        for sname, js in jconfigs.SHAPES.items():
            ts = tconfigs.SHAPES[sname]
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            assert tconfigs.shape_applicable(tc, ts) == \
                jconfigs.shape_applicable(jc, js)
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")


def _pd_tree(defs):
    if isinstance(defs, dict):
        return {k: _pd_tree(v) for k, v in defs.items()}
    return (tuple(defs.shape), tuple(defs.axes), defs.init)


@pytest.mark.parametrize("name", ARCHS)
def test_model_defs_and_axes_equal_the_reference(name):
    for reduce in (False, True):
        jc, tc = jconfigs.ALL[name], tconfigs.ALL[name]
        if reduce:
            jc, tc = jc.reduced(), tc.reduced()
        assert _pd_tree(TM.model_defs(tc)) == _pd_tree(JM.model_defs(jc))
        assert TM.param_axes(tc) == JM.param_axes(jc)
        shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                              JM.param_shapes(jc))
        assert TT.tree_map(lambda t: (tuple(t.shape), "float32"),
                           TM.param_shapes(tc)) == shapes


@pytest.mark.parametrize("name", ARCHS)
def test_input_specs_and_flops_equal_the_reference(name):
    jc, tc = jconfigs.ALL[name], tconfigs.ALL[name]
    for sname, shape in jconfigs.SHAPES.items():
        if jconfigs.shape_applicable(jc, shape):
            continue
        ref = jax.tree.map(lambda s: (tuple(s.shape), JDTYPE[s.dtype]),
                           JM.input_specs(jc, shape))
        specs = TM.input_specs(tc, tconfigs.SHAPES[sname])
        leaves = [t for _, t in TT.tree_leaves(specs)]
        assert leaves and all(t.device.type == "meta" for t in leaves)
        assert TT.tree_map(lambda t: (tuple(t.shape), t.dtype), specs) == ref
        assert TM.model_flops(tc, tconfigs.SHAPES[sname]) == \
            JM.model_flops(jc, shape)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_kinds(name):
    """Deterministic kinds equal the reference's init; normal kinds have
    its scales (0.02, and 0.02/√(2L) for normal_out); one seed, one draw."""
    tc = tconfigs.ALL[name].reduced()
    jc = jconfigs.ALL[name].reduced()
    ref = jax.tree.map(np.asarray, JM.init_params(jc, jax.random.PRNGKey(3)))
    ref_leaves = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    port_params = TM.init_params(tc, 3, device="cpu")
    again = TM.init_params(tc, 3, device="cpu")
    other = TM.init_params(tc, 4, device="cpu")
    defs = dict(TT.tree_leaves(TM.model_defs(tc)))
    moved = False
    for path, t in TT.tree_leaves(port_params):
        pd = defs[path]
        r = ref_leaves[tuple(jax.tree_util.DictKey(k) for k in path)]
        assert t.dtype == torch.float32 and tuple(t.shape) == r.shape
        assert torch.equal(t, dict(TT.tree_leaves(again))[path])
        if pd.init in ("normal", "normal_out"):
            want = 0.02 if pd.init == "normal" else \
                0.02 / np.sqrt(2 * tc.n_layers)
            n = t.numel()
            assert abs(float(t.mean())) < 5 * want / np.sqrt(n)
            assert abs(float(t.std()) / want - 1) < max(0.25, 5 / np.sqrt(n))
            moved |= not torch.equal(t, dict(TT.tree_leaves(other))[path])
        else:
            np.testing.assert_array_equal(t.numpy(), r)
    assert moved


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "whisper-large-v3",
                                  "qwen3-8b"])
def test_synth_batch_matches_the_reference_specs(name):
    jc, tc = jconfigs.ALL[name].reduced(), tconfigs.ALL[name].reduced()
    ref = JM.synth_batch(jc, 2, 32, jax.random.PRNGKey(0))
    batch = TM.synth_batch(tc, 2, 32, 5, device="cpu")
    assert {k: (tuple(v.shape), JDTYPE[v.dtype]) for k, v in ref.items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
    again = TM.synth_batch(tc, 2, 32, 5, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    assert int(batch["tokens"].min()) >= 0
    assert int(batch["tokens"].max()) < tc.vocab
