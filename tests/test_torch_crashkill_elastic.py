"""The crash-kill harness's elastic tier (``tools/crashkill_torch.py run
--elastic-only``, JAX ``tools/crashkill.py``'s tier) on the CPU: the MLP
job of the harness through gloo process groups at dp 4, 2 and 1.

- An uninterrupted dp-4 reference and a dp-2 floor run measure the
  reduction-order floor; a kill/resume cycle over the worlds 4 -> 2 -> 1
  (a SIGTERM to one rank of the dp-4 segment: the ranks agree and save
  together; a SIGKILL to every rank of the dp-2 segment, under a slowed
  writer) probes a loadable latest after each kill and ends within
  ``max(10 * floor, 1e-6)`` of the reference and within the fixed
  ``--elastic-max`` bound.
- ``bench`` still raises, naming where it went (the benchmark tools).
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "crashkill_torch.py")


def test_elastic_tier_4_2_1(tmp_path):
    res = subprocess.run(
        [sys.executable, TOOL, "run", "--quick", "--device", "cpu",
         "--elastic-only", "--worlds", "4,2,1", "--steps", "120",
         "--snapshot-every", "20", "--elastic-max", "1.23e-4",
         "--workdir", str(tmp_path / "work")],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    out = res.stdout
    assert res.returncode == 0, out[-4000:] + res.stderr[-4000:]
    assert re.search(r"kill #1: SIGTERM .* dp=4 rc=\[-15, -15, -15, -15\]",
                     out), out
    assert re.search(r"kill #2: SIGKILL .* dp=2 rc=\[-9, -9\]", out), out
    assert out.count("probe: PROBE_OK") == 2, out
    assert "completing run: dp=1" in out, out
    floor = float(re.search(r"no kills\): ([0-9.e+-]+)", out).group(1))
    assert floor > 0.0       # dp 4 and dp 2 add in other orders
    m = re.search(r"elastic trajectory: (BIT-IDENTICAL|max \|delta\| = "
                  r"([0-9.e+-]+))", out)
    assert m, out
    if m.group(2):
        assert float(m.group(2)) <= max(10 * floor, 1e-6)
        assert "against the fixed bound 1.230e-04" in out, out
    assert "crashkill: PASS" in out


def test_bench_still_raises_and_says_where_it_went():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import crashkill_torch as ck
    finally:
        sys.path.pop(0)
    with pytest.raises(NotImplementedError, match="benchmark tools"):
        ck.main(["bench"])
