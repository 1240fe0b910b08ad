"""The LM training path (``repro_torch.train``) on the card against the
port's own CPU run, for all ten architectures at their reduced size: part
(a) of ``chip_smoke.py``'s LM training phase (``lm_train_reduced_arch``),
one test an arch. In f32 with TF32 off, the same state (``init_params``
and ``optimizer.init`` on the CPU, then copied) and batch: one train step's
metrics, every gradient leaf, the new parameters, ``m``, ``v`` and
``step`` within rtol 2e-4, atol 2e-5, ``step`` and the MoE routing
(``route``'s top-k indices, forward and remat's recompute) bitwise.

Every test here is marked ``cuda`` and skips, with its reason, where torch
sees no CUDA device. It imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_train_card.py
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ALL

ARCHS = sorted(ALL)


@pytest.fixture(scope="module")
def smoke_env():
    """(chip_smoke, its Env) with TF32 off; skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test holds the card's train "
                    "step to the CPU's (torch.cuda.is_available() is false)")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield smoke, smoke.Env()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = old


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHS)
def test_reduced_train_step_on_the_card_is_the_cpus(name, smoke_env):
    smoke, env = smoke_env
    assert smoke.lm_train_reduced_arch(env, name) <= 1.0
