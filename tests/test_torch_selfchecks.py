"""The port's three telemetry self-checks (``tools/profile_check_torch.py``,
``tools/health_check_torch.py``, ``tools/serve_slo_check_torch.py``; the
JAX package's ``tools/profile_check.py``, ``health_check.py`` and
``serve_slo_check.py``) on the CPU at tiny size: each exits 0 as a
command, and 1 on its seeded failure (a capture whose trace file is
deleted before the drain; an induced step without its NaN; a gap opened
in one request's timeline).
"""
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("profile_check_torch", "health_check_torch",
         "serve_slo_check_torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny models: one intra-op thread keeps parallel test workers from
    contending."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tool", TOOLS)
def test_selfcheck_passes_on_the_cpu(tool, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", f"{tool}.py"),
         "--cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert f"{tool}: PASS" in proc.stdout


@pytest.mark.parametrize("tool", TOOLS)
def test_selfcheck_fails_on_its_seeded_failure(tool, capsys):
    assert load_tool(tool).main(["--cpu", "--seed-failure"]) == 1
    out = capsys.readouterr().out
    assert f"{tool} FAIL:" in out and "PASS" not in out
