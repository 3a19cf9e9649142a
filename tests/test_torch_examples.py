"""The port's example trainers (``examples/*/train_torch.py``) against the
JAX package's (``examples/*/train.py``), on the CPU at gpt2-tiny /
bert-tiny.

- Each builds the same batches as its JAX example, step by step (bit-equal
  numpy from the same seeds): both scripts' ``main`` run with
  ``initialize`` replaced by an engine that records what ``train_batch``
  gets.
- Each prints the stdout contract (``losses:`` and ``final loss:``, then a
  JSON line) and its loss falls by ``tests/test_examples.py``'s
  ``assert_decreasing`` rule, with ``--device cpu``.
- The CIFAR net, given the JAX example's ``init_params`` as numpy, gives
  its ``loss_fn`` value within 1e-5 (fp32).
- ``--pipeline`` trains ``ds_config_pipeline.json`` (pp 2 x dp 4) at
  gpt2-tiny under ``bin/deepspeed_torch``.
"""
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "examples", "data", "corpus.txt")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Under the driver's six workers, one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_example(name, port):
    rel = os.path.join("examples", name,
                       "train_torch.py" if port else "train.py")
    mod_name = f"_example_{name}_{'torch' if port else 'jax'}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(
        mod_name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class RecordingEngine:
    """Stands in for the engine: keeps every batch, returns loss 0."""
    dp, dp_rank, device = 1, 0, torch.device("cpu")

    def __init__(self):
        self.batches = []

    def train_batch(self, batch):
        self.batches.append(batch)
        return 0.0


def recorded_batches(monkeypatch, name, port, argv):
    mod = load_example(name, port)
    eng = RecordingEngine()
    pkg = deepspeed_tpu_torch if port else deepspeed_tpu
    monkeypatch.setattr(pkg, "initialize",
                        lambda **kw: (eng, None, None, None))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main(argv) if port else mod.main()
    return eng.batches


def _leaves(batch):
    return list(batch) if isinstance(batch, tuple) else [batch]


@pytest.mark.parametrize("name,argv", [
    ("gpt2", ["--steps", "20"]),
    ("gpt2", ["--steps", "6", "--data", CORPUS]),
    ("bert", ["--steps", "20"]),
    ("cifar", ["--steps", "12"])], ids=["gpt2-markov", "gpt2-corpus",
                                        "bert", "cifar"])
def test_batches_match_jax_example(monkeypatch, capsys, name, argv):
    want = recorded_batches(monkeypatch, name, False, argv)
    got = recorded_batches(monkeypatch, name, True, argv + ["--device",
                                                             "cpu"])
    assert len(got) == len(want) == int(argv[1])
    for g, w in zip(got, want):
        gl, wl = _leaves(g), _leaves(w)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def run_main(capsys, name, argv):
    load_example(name, True).main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"final (?:MLM )?loss:\s*([0-9.]+)", out)
    c = re.search(r"losses:\s*([0-9. eE+-]+)", out)
    assert m and c, out[-2000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["world_size"] == 1, rec
    return float(m.group(1)), [float(x) for x in c.group(1).split()], rec


def assert_decreasing(losses, factor=0.97):
    """tests/test_examples.py's rule: the last quarter's mean under
    ``factor`` of the first quarter's."""
    k = max(1, len(losses) // 4)
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    assert last < factor * first, (first, last, losses)


def test_cifar_example_learns(capsys):
    loss, curve, rec = run_main(capsys, "cifar", ["--steps", "60"])
    assert loss < 2.3, loss            # below the ln(10) random floor
    assert_decreasing(curve)
    assert len(rec["step_ms"]) == 60


def test_bert_example_learns(capsys):
    _, curve, _ = run_main(capsys, "bert", ["--steps", "48"])
    assert_decreasing(curve)


def test_gpt2_example_zero2_real_text(capsys):
    loss, curve, rec = run_main(capsys, "gpt2", [
        "--deepspeed_config", os.path.join(REPO, "examples", "gpt2",
                                           "ds_config_zero2.json"),
        "--data", CORPUS, "--steps", "24", "--local_rank", "0"])
    assert curve[0] < 7.0                 # near the ln(512) start
    assert loss < 5.0, loss               # well under the uniform floor
    assert_decreasing(curve, factor=0.85)
    # on the CPU the plain versions run: no kernel launches
    assert set(rec["launches"].values()) == {0}


def test_cifar_loss_matches_jax():
    jex = load_example("cifar", False)
    tex = load_example("cifar", True)
    import jax
    jparams = jex.init_params(jax.random.PRNGKey(0))
    x, y = jex.synthetic_cifar(64)
    want = float(jex.loss_fn(jparams, (x, y), None))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in
               jparams.items()}
    got = float(tex.loss_fn(tparams, (torch.from_numpy(x),
                                      torch.from_numpy(y))))
    assert abs(got - want) <= 1e-5, (got, want)


def test_gpt2_pipeline_raises(tmp_path):
    """``--pipeline`` (no longer refused) trains ``ds_config_pipeline.json``
    (pp 2 x dp 4, bf16, ``1f1b``) at gpt2-tiny for 2 steps: 8 gloo
    processes under ``bin/deepspeed_torch``, rank 0 printing the stdout
    contract."""
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("localhost slots=8\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bin", "deepspeed_torch"),
         "--hostfile", str(hostfile), "--master_port", str(port),
         os.path.join(REPO, "examples", "gpt2", "train_torch.py"),
         "--pipeline", "--device", "cpu", "--steps", "2",
         "--config", "ds_config_pipeline.json"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    losses = [float(x) for x in re.search(r"^losses: (.*)$", res.stdout,
                                          re.M).group(1).split()]
    assert len(losses) == 2 and all(np.isfinite(losses))
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["world_size"] == 4 and rec["device"] == "cpu"
    assert res.stdout.count("final loss:") == 1


def test_cuda_run_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example("cifar", True).main(["--steps", "1"])
