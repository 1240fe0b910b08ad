"""repro_torch's LM serving path in bf16 for each of the ten reduced archs
on the CPU against the JAX reference in bf16, on the reference's weights
(``params_from_jax``) and the same seeded inputs: ``forward`` logits and
aux, a 56-token ``prefill``'s logits and cache, and 4 ``decode_step``s'
logits and the cache they leave. Every float output within BF16_BAR times
``eps`` of the reference's, relative to its largest magnitude, where
``eps`` is the reference's own bf16 forward logits' relative distance to
its f32 forward's on the same weights (a leaf stored in bf16 may differ
by one more unit in the last place); integer leaves bitwise; dtypes and
shapes equal. The single ops in bf16: ``test_torch_lm_bf16.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from test_torch_lm_bf16 import _f32, bf16, rel, ulp_rel
from test_torch_lm_models import PRE, S, STEPS, inputs, prompt

ARCHS = sorted(jconfigs.ALL)
# a whole arch's bf16 outputs within this many times the reference's own
# bf16-vs-f32 relative distance (measured worst 1.26, hymba's; a
# norm computed in bf16 gives 2.5-3.0)
BF16_BAR = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_ref(cfg, params, jb):
    logits, _, aux = JM.forward(cfg, params, jb)
    out = {"forward logits": logits, "aux": aux}
    lg, cache = JM.prefill(cfg, params, prompt(jb, PRE), cache_len=S)
    out["prefill logits"] = lg
    out.update({f"prefill {k}": v for k, v in cache.items()})
    for t in range(PRE, PRE + STEPS):
        lg, cache = JM.decode_step(cfg, params, cache,
                                   jb["tokens"][:, t:t + 1], jnp.int32(t))
        out[f"decode {t} logits"] = lg
    out.update({f"decode {k}": v for k, v in cache.items()})
    return out


def _serve_port(cfg, params, tb):
    logits, _, aux = TM.forward(cfg, params, tb)
    out = {"forward logits": logits, "aux": aux}
    lg, cache = TM.prefill(cfg, params, prompt(tb, PRE), cache_len=S)
    out["prefill logits"] = lg
    out.update({f"prefill {k}": v.clone() for k, v in cache.items()})
    for t in range(PRE, PRE + STEPS):
        lg, cache = TM.decode_step(cfg, params, cache,
                                   tb["tokens"][:, t:t + 1], t)
        out[f"decode {t} logits"] = lg
    out.update({f"decode {k}": v for k, v in cache.items()})
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_arch_matches_reference(name):
    """The reduced arch in bf16: every float output of the port within
    BF16_BAR times ``eps`` of the reference's, relative to its largest
    magnitude, where ``eps`` is the reference's own bf16 forward logits'
    relative distance to its f32 forward's on the same weights."""
    cfg32 = jconfigs.ALL[name].reduced()
    cfg = bf16(cfg32)
    params = JM.init_params(cfg32, jax.random.PRNGKey(0))
    batch = inputs(cfg32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = _serve_ref(cfg, params, jb)
    eps = rel(JM.forward(cfg32, params, jb)[0], ref["forward logits"])
    tcfg = bf16(tconfigs.ALL[name].reduced())
    tp = TM.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    port = _serve_port(tcfg, tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert set(port) == set(ref)
    worst = 0.0
    for what, r in ref.items():
        p = port[what]
        assert str(r.dtype) == str(p.dtype).replace("torch.", ""), what
        assert tuple(r.shape) == tuple(p.shape), what
        if not p.dtype.is_floating_point:
            np.testing.assert_array_equal(p.numpy(), np.asarray(r),
                                          err_msg=what)
        elif np.abs(_f32(r)).max() > 0:
            # a leaf stored in bf16 may also round to the neighbouring value
            floor = ulp_rel(r) if p.dtype == torch.bfloat16 else 0.0
            assert rel(r, p) <= BF16_BAR * eps + floor, \
                (what, rel(r, p), eps, floor)
            worst = max(worst, (rel(r, p) - floor) / eps)
        else:
            assert not p.any(), what
    print(f"{name}: eps {eps:.4g}, worst output {worst:.3f} eps beyond its "
          "floor")
