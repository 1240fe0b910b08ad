import gc
import os
import sys

import pytest

# Tests must see exactly ONE device (the dry-run alone uses 512 placeholder
# devices, set inside launch/dryrun.py before any jax import — never here).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    # The suite jit-compiles hundreds of distinct programs (engine × knob ×
    # dims parity sweeps); letting every executable stay live for the whole
    # run eventually crashes XLA:CPU's compiler late in the suite (segfault
    # inside backend_compile on otherwise-fine programs). Dropping compiled
    # caches at module boundaries bounds the accumulation; modules rarely
    # share traces, so the recompile cost is small.
    yield
    import jax
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel of repro_torch on the card; "
        "skips, with its reason, where torch sees no CUDA device")
