"""The frozen Porto stand-in equals the program's ``taxi2d``, bit for
bit."""
import numpy as np
import pytest

from portbench.data import taxi2d
from repro_torch.data import synth


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**33 + 2])
def test_frozen_taxi2d_is_bitwise_the_programs(seed):
    ours = taxi2d.generate(3_000, seed)
    theirs = synth.load("taxi2d", 3_000, seed)
    assert ours.dtype == np.float32 and ours.shape == (3_000, 3)
    assert ours.tobytes() == theirs.tobytes()
