"""repro_torch's training loop (``train/trainer.train_loop``), its exact
resume, ``data/pipeline.token_batches`` and the train CLI
(``launch/train.py``), on the CPU against the JAX reference.

Reduced granite-moe-1b-a400m in f32 (the reference's resume test's arch),
both loops started from the same state (``state_from_jax``) on one list
of batches (the reference's ``synth_batch``, as numpy) indexed by step:

  * 6 steps of both loops give loss histories within rtol 2e-4;
  * the port's 3 steps with a checkpoint, then a fresh ``train_loop`` to 6,
    equal its uninterrupted 6 steps bitwise (parameters, ``m``, ``v``,
    ``step``), and the resumed history starts at step 4;
  * a checkpoint the reference's loop wrote after 3 steps, resumed by the
    port's to 6, matches the reference's uninterrupted 6 at rtol 2e-4.

``token_batches`` draws with ``torch.Generator`` where the reference draws
with ``jax.random``, so the two streams differ in their bits and the test
holds the port to the stream's contract (ROADMAP §3), and both streams to
what they are for: each drives its package's loop on reduced qwen3-8b to
a final loss below half of ln(256).
"""
import math
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.distributed.checkpoint import tree_flatten
from repro_torch.launch import train as tcli
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NAME = "granite-moe-1b-a400m"
OCFG = dict(lr=1e-3)
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor operations beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def setup():
    """(reference cfg, port cfg, initial state as numpy, the batches)."""
    jcfg = jconfigs.ALL[NAME].reduced()
    tcfg = tconfigs.ALL[NAME].reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    state = jax.tree.map(np.asarray,
                         jtrainer.TrainState(params, jopt.init(params)))
    key = jax.random.PRNGKey(42)
    batches = []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        batches.append(jax.tree.map(np.asarray,
                                    JM.synth_batch(jcfg, 2, 32, k)))
    return jcfg, tcfg, state, batches


def torch_batches(batches):
    return iter([{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                 for b in batches])


@pytest.fixture(scope="module")
def ref_runs(setup, tmp_path_factory):
    """The reference's uninterrupted 6 steps, and the directory of its 3
    steps with a checkpoint (one compiled step for both)."""
    jcfg, _, state, batches = setup
    step_fn = jax.jit(jtrainer.make_train_step(jcfg,
                                               jopt.AdamWConfig(**OCFG)),
                      donate_argnums=0)
    fresh = lambda: jax.tree.map(jax.numpy.asarray, state)  # noqa: E731
    s6, h6 = jtrainer.train_loop(
        jcfg, jtrainer.TrainerConfig(total_steps=STEPS, log_every=100),
        jopt.AdamWConfig(**OCFG), iter(batches), state=fresh(),
        step_fn=step_fn, log=quiet)
    d = str(tmp_path_factory.mktemp("ref") / "ck")
    jtrainer.train_loop(
        jcfg, jtrainer.TrainerConfig(total_steps=3, ckpt_dir=d, ckpt_every=3,
                                     log_every=100),
        jopt.AdamWConfig(**OCFG), iter(batches), state=fresh(),
        step_fn=step_fn, log=quiet)
    return jax.tree.map(np.asarray, s6), h6, d


def port_loop(setup, total, ckpt_dir=None, start=0):
    _, tcfg, state, batches = setup
    return ttrainer.train_loop(
        tcfg, ttrainer.TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                     ckpt_every=3, log_every=100),
        topt.AdamWConfig(**OCFG), torch_batches(batches[start:]),
        state=ttrainer.state_from_jax(tcfg, state, device="cpu"),
        log=quiet, device="cpu")


def leaves(state):
    return [x.detach() for x in tree_flatten(state)[0]]


def close_to_reference(port_state, ref_state):
    ref = jax.tree.leaves(ref_state)
    port = leaves(port_state)
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), r, rtol=2e-4, atol=2e-5)


def test_loop_matches_reference(setup, ref_runs):
    s6, h6, _ = ref_runs
    state, hist = port_loop(setup, STEPS)
    assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
    assert set(hist[0]) == set(h6[0])
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose([h[k] for h in hist], [h[k] for h in h6],
                                   rtol=2e-4, err_msg=k)
    close_to_reference(state, s6)
    assert all(h["slow_steps"] >= 0 and h["dt"] > 0 for h in hist)


def test_resume_is_bitwise_the_uninterrupted_run(setup, tmp_path):
    full, _ = port_loop(setup, STEPS)
    d = str(tmp_path / "ck")
    port_loop(setup, 3, ckpt_dir=d)
    assert tckpt.latest_step(d) == 3
    resumed, h2 = port_loop(setup, STEPS, ckpt_dir=d, start=3)
    assert h2[0]["step"] == 4 and len(h2) == 3
    assert type(resumed) is ttrainer.TrainState
    assert int(resumed.opt.step) == STEPS == int(full.opt.step)
    for a, b in zip(leaves(full), leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tckpt.available_steps(d) == [3, 6]


def test_resume_from_a_reference_checkpoint(setup, ref_runs):
    s6, h6, ref_dir = ref_runs
    _, tcfg, state, batches = setup
    logs = []
    resumed, hist = ttrainer.train_loop(
        tcfg, ttrainer.TrainerConfig(total_steps=STEPS, ckpt_dir=ref_dir,
                                     ckpt_every=3, log_every=100),
        topt.AdamWConfig(**OCFG), torch_batches(batches[3:]),
        state=ttrainer.state_from_jax(tcfg, state, device="cpu"),
        log=logs.append, device="cpu")
    assert logs == ["[trainer] resumed from step 3"]
    assert [h["step"] for h in hist] == [4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in h6[3:]], rtol=2e-4)
    close_to_reference(resumed, s6)


def test_straggler_counter_and_cadence(setup, tmp_path, monkeypatch):
    """A step slower than ``straggler_factor`` × the EWMA (this step's
    included) after the first four counts as slow; logs every
    ``log_every``; keep-K checkpoints. The loop's clock is a fake one, so
    the step times are the test's."""
    _, tcfg, state, batches = setup
    durations = iter([0.1, 0.1, 0.1, 0.1, 0.2, 1.0])
    clock = {"now": 0.0, "start": True}

    def perf_counter():
        if not clock["start"]:
            clock["now"] += next(durations)
        clock["start"] = not clock["start"]
        return clock["now"]

    monkeypatch.setattr(ttrainer, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))
    logs = []
    d = str(tmp_path / "ck")
    _, hist = ttrainer.train_loop(
        tcfg, ttrainer.TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_every=2,
                                     keep=2, log_every=3,
                                     straggler_factor=2.0),
        topt.AdamWConfig(**OCFG), torch_batches(batches),
        state=ttrainer.state_from_jax(tcfg, state, device="cpu"),
        log=logs.append, device="cpu")
    # step 5: 0.2 <= 2 × 0.11 (the EWMA); step 6: 1.0 > 2 × 0.199
    assert [h["dt"] for h in hist] == pytest.approx(
        [0.1, 0.1, 0.1, 0.1, 0.2, 1.0])
    assert [h["slow_steps"] for h in hist] == [0, 0, 0, 0, 0, 1]
    assert [s.split()[2] for s in logs] == ["3", "6"]
    assert tckpt.available_steps(d) == [4, 6]


# ------------------------------------------------------------ token_batches


def test_token_batches_contract():
    cfg = tconfigs.ALL["qwen3-8b"].reduced()
    B, S = 64, 128
    it = tpipeline.token_batches(cfg, B, S, seed=3, device="cpu")
    first = [next(it) for _ in range(3)]
    b = first[0]
    assert set(b) == {"tokens", "labels"}
    for k in ("tokens", "labels"):
        assert b[k].shape == (B, S) and b[k].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], 1)  # S + 1
    # the support: 64 distinct tokens below vocab, fixed by the seed
    support = torch.unique(toks)
    clean = [t for t in support.tolist()
             if (toks == t).sum() > 0.5 * B * (S + 1) / 64]
    assert len(clean) == 64 and max(clean) < cfg.vocab
    # the cycle: each support token's successor is one fixed token, but
    # where noise moved either (5% of positions, (tok + 1) % vocab)
    nxt = {}
    for a, c in zip(toks[:, :-1].reshape(-1).tolist(),
                    toks[:, 1:].reshape(-1).tolist()):
        if a in clean and c in clean:
            nxt.setdefault(a, []).append(c)
    succ = {a: max(set(cs), key=cs.count) for a, cs in nxt.items()}
    assert sorted(succ) == sorted(clean) == sorted(succ.values())
    order, t = [], clean[0]
    for _ in range(64):
        order.append(t)
        t = succ[t]
    assert t == clean[0] and len(set(order)) == 64   # one cycle of 64
    noisy = ~torch.isin(toks, torch.tensor(clean))
    assert 0.02 <= float(noisy.float().mean()) <= 0.08
    moved = toks[noisy]
    assert bool(torch.isin((moved - 1) % cfg.vocab,
                           torch.tensor(clean)).all())
    # start_step=k is the k-th batch of a stream started at 0
    again = next(tpipeline.token_batches(cfg, B, S, seed=3, start_step=2,
                                         device="cpu"))
    assert all(torch.equal(again[k], first[2][k]) for k in again)
    assert not torch.equal(first[1]["tokens"], first[2]["tokens"])
    other = next(tpipeline.token_batches(cfg, B, S, seed=4, device="cpu"))
    assert not torch.equal(other["tokens"], b["tokens"])


@pytest.mark.parametrize("name", ["qwen2-vl-72b", "whisper-large-v3"])
def test_token_batches_other_inputs(name):
    cfg = tconfigs.ALL[name].reduced()
    b = next(tpipeline.token_batches(cfg, 2, 32, device="cpu"))
    ref = jax.tree.map(np.asarray, next(jpipeline.token_batches(
        jconfigs.ALL[name].reduced(), 2, 32)))
    assert set(b) == set(ref)
    for k in ref:
        assert tuple(b[k].shape) == ref[k].shape, k
        assert str(b[k].dtype).split(".")[1] == str(ref[k].dtype), k


def test_token_batches_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.ALL["qwen3-8b"].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tpipeline.token_batches(cfg, 2, 8))


def test_both_streams_are_learnable():
    """Each package's stream drives its own loop on reduced qwen3-8b (B 8,
    S 32, lr 1e-2, 40 steps) below half of ln(256)."""
    name, steps = "qwen3-8b", 40
    kw = dict(lr=1e-2, warmup_steps=4, total_steps=steps)
    jcfg = jconfigs.ALL[name].reduced()
    _, jh = jtrainer.train_loop(
        jcfg, jtrainer.TrainerConfig(total_steps=steps, log_every=1000),
        jopt.AdamWConfig(**kw), jpipeline.token_batches(jcfg, 8, 32),
        log=quiet)
    tcfg = tconfigs.ALL[name].reduced()
    _, th = ttrainer.train_loop(
        tcfg, ttrainer.TrainerConfig(total_steps=steps, log_every=1000),
        topt.AdamWConfig(**kw),
        tpipeline.token_batches(tcfg, 8, 32, device="cpu"), log=quiet,
        device="cpu")
    bar = 0.5 * math.log(256)
    assert jh[-1]["loss"] < bar and th[-1]["loss"] < bar, \
        (jh[-1]["loss"], th[-1]["loss"])
    assert th[0]["loss"] > math.log(256) - 1


# --------------------------------------------------------------------- CLI


def test_cli_trains_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` prints the final loss and
    checkpoints; a second call (in this process) resumes from it."""
    d = str(tmp_path / "ck")
    args = ["--arch", NAME, "--reduced", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", d]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + args + ["--steps", "4"], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"^final loss: \d+\.\d{4} after 4 steps$", r.stdout,
                     re.M), r.stdout
    assert tckpt.latest_step(d) == 4
    state, hist = tcli.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "[trainer] resumed from step 4" in out
    assert "after 2 steps" in out and int(state.opt.step) == 6
    _, hist = tcli.main(args + ["--steps", "6"])
    assert hist == [] and "no step to run" in capsys.readouterr().out


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--arch", NAME, "--reduced", "--steps", "1"])
    cfg = tconfigs.ALL[NAME].reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.train_loop(cfg, ttrainer.TrainerConfig(total_steps=1),
                            topt.AdamWConfig(), iter([]))
