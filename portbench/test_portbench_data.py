"""The frozen dataset generators equal the program's, bit for bit."""
import numpy as np
import pytest

from portbench.data import iono3d, roadnet2d
from repro_torch.data import synth


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3 * 2**33 + 2])
@pytest.mark.parametrize("frozen, name", [(roadnet2d, "roadnet2d"),
                                          (iono3d, "iono3d")])
def test_frozen_generator_is_bitwise_the_programs(frozen, name, seed):
    ours = frozen.generate(3_000, seed)
    theirs = synth.load(name, 3_000, seed)
    assert ours.dtype == np.float32 and ours.shape == (3_000, 3)
    assert ours.tobytes() == theirs.tobytes()
