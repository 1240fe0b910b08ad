"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
program), and the reference and the data load nothing of ``repro_torch``
either. Each check runs in a fresh interpreter, since the test process
may hold JAX for other tests."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from portbench import harness
import portbench.control, portbench.run
for name in ("roadnet2d-435k.cluster", "iono3d-1m.minpts"):
    cell = harness.load_cell(name)
    cell.config.update(n=1500)
    cell.traffic.update(pool=1, min_pts=[4])
    out = harness.run_cell(cell, 3, 0.0, False, "cpu", 0.0)
    for m in cell.end_to_end + cell.per_layer:
        harness.load_reader(m["name"])(out)
    assert out.correct
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
from portbench.reference import dbscan as ref
from portbench.data import iono3d, roadnet2d
from portbench import check, readers, roofline
for gen, eps, dims in ((roadnet2d, 0.1, 2), (iono3d, 8.0, 3)):
    a = ref.answer(ref.neighbour_pairs(gen.generate(1500, 3), eps, dims,
                                       device="cpu"), 8)
    check.compare(a, a.counts, a.core, a.labels)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


MEASURE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}, {stub!r}]
import torch
torch.set_num_threads(1)
from portbench import harness, run
real = harness.load_reader


def load_reader(name):
    if name != "setup_s" or not {importing!r}:
        return real(name)

    def read(out):
        import jax  # noqa: F401  (a stub module of that name)
        return out.setup_s
    return read


harness.load_reader = load_reader
cell = harness.load_cell("roadnet2d-435k.cluster")
cell.config.update(n=1500)
cell.traffic.update(pool=1)
sys.exit(run.measure(cell, 5, 0.0, False, "cpu"))
"""


def _top_level_names(code):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)       # only what the code puts on the path
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           src=str(ROOT / "src"))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_level_names(HARNESS)
    assert "repro_torch" in names and "portbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("importing", [True, False],
                         ids=["reader_loads_jax", "sound"])
def test_a_run_that_loads_jax_while_reading_its_metrics_prints_nothing(
        tmp_path, importing):
    # the check comes after the whole result line is built, metric readers
    # included, so a reader that loads JAX fails the run
    (tmp_path / "jax.py").write_text("")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    code = MEASURE.format(root=str(ROOT), src=str(ROOT / "src"),
                          stub=str(tmp_path), importing=importing)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    lines = out.stdout.strip().splitlines()
    if importing:
        assert out.returncode == 4, out.stderr[-4000:]
        assert not any(x.startswith("{") for x in lines)
        assert "loaded in the benchmark's process: jax" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-4000:]
        assert json.loads(lines[-1])["correct"] is True
