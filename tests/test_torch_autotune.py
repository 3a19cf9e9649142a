"""The port's tile resolver (``deepspeed_tpu_torch/ops/autotune.py``)
against the JAX package's (``deepspeed_tpu/ops/autotune.py``).

The same scripted calls go to both with ``DS_AUTOTUNE_FORCE=1``, a
deterministic fake ``measure`` and a registry in ``tmp_path`` each: the
returns, the counters, the measure calls and the registry entries
(``tile``, ``heuristic``, ``timings_s``, ``speedup_vs_heuristic``) must
be equal, and the keys equal apart from their card part. Then the call
sites: under ``DS_AUTOTUNE=0`` K9's BN is ``_gg_tile``'s, K7/K8's
super-tile ``pick_tile``'s, and K10's split count ``paged_splits``'
(the split is not behind the resolver); with a registry entry K9 and K7
take the entry's tile.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import autotune as jat
from deepspeed_tpu_torch.ops import autotune as tat
from deepspeed_tpu_torch.ops import grouped_gemm as tgg
from deepspeed_tpu_torch.ops import paged_attention as tpa
from deepspeed_tpu_torch.ops import sparse_flash as tsf


class CountingMeasure:
    """measure(tile): deterministic timings; a tile without one raises
    (a candidate that does not build)."""

    def __init__(self, timings):
        self.timings = dict(timings)
        self.calls = []

    def __call__(self, tile):
        self.calls.append(tile)
        try:
            return self.timings[tile]
        except KeyError:
            raise RuntimeError(f"candidate {tile} does not build")


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("DS_AUTOTUNE_FORCE", "1")
    monkeypatch.delenv("DS_AUTOTUNE", raising=False)
    yield monkeypatch
    jat.reset()
    tat.reset()


# Each step: ("resolve", kernel, shape, dtype, heuristic, candidates,
# timings or None), ("env", name, value or None), ("fresh",) (the
# in-memory registry dropped: a new process), ("write", raw text).
SCRIPTS = {
    "disabled": [("env", "DS_AUTOTUNE", "0"),
                 ("resolve", "k", (8, 128), "float32", 64, (32, 64),
                  {32: 0.1, 64: 0.5})],
    "cpu_without_force": [("env", "DS_AUTOTUNE_FORCE", None),
                          ("resolve", "k", (8, 128), "float32", 64,
                           (32, 64), {32: 0.1, 64: 0.5})],
    "search_then_hit": [
        ("resolve", "fused_ln_fwd", (512, 768, 5), "float32", 64,
         (32, 64, 128), {32: 0.01, 64: 0.05, 128: 0.03}),
        ("resolve", "fused_ln_fwd", (512, 768, 5), "float32", 64,
         (32, 64, 128), {}),
        ("fresh",),
        ("resolve", "fused_ln_fwd", (512, 768, 5), "float32", 64,
         (32, 64, 128), {})],
    "tuple_tiles": [
        ("resolve", "grouped_gemm", (8, 256, 512, 1024), "bfloat16",
         (128, 128), [(128, 128), (256, 128)],
         {(128, 128): 0.02, (256, 128): 0.01}),
        ("fresh",),
        ("resolve", "grouped_gemm", (8, 256, 512, 1024), "bfloat16",
         (128, 128), [(128, 128), (256, 128)], {})],
    "corrupt_file": [
        ("write", "{ this is not json"),
        ("resolve", "k", (4, 4), "float32", 64, (64,), None),
        ("resolve", "k", (4, 4), "float32", 64, (32, 64),
         {32: 0.01, 64: 0.02})],
    "stale_entry": [
        ("write", json.dumps({"k|float32[4,4]|CARD": {"tile": 999}})),
        ("resolve", "k", (4, 4), "float32", 64, (32, 64),
         {32: 0.02, 64: 0.01})],
    "failing_candidate": [("resolve", "k", (9, 9), "float32", 64, (32, 64),
                           {64: 0.02})],
    "no_measure": [("resolve", "k", (3, 3), "float32", 64, (32, 64), None)],
    "all_candidates_fail": [("resolve", "k", (5, 5), "float32", 64,
                             (32, 64), {})],
    "heuristic_joins_candidates": [
        ("resolve", "sparse_flash", (24, 4096, 64, 12, 32, 32, 528, 1),
         "bfloat16", (2, 8), [(1, 1), (1, 2)],
         {(1, 1): 0.3, (1, 2): 0.2, (2, 8): 0.25})],
}


def run_script(mod, script, path, monkeypatch):
    """Returns what the script saw: each resolve's return and measure
    calls, the counters and the registry (keys without the card part,
    entries without the time of recording)."""
    monkeypatch.setenv("DS_AUTOTUNE_REGISTRY", path)
    monkeypatch.setenv("DS_AUTOTUNE_FORCE", "1")
    monkeypatch.delenv("DS_AUTOTUNE", raising=False)
    mod.reset()
    card = mod.chip_kind() if mod is jat else mod.card_kind()
    seen = []
    for step in script:
        if step[0] == "env":
            if step[2] is None:
                monkeypatch.delenv(step[1], raising=False)
            else:
                monkeypatch.setenv(step[1], step[2])
        elif step[0] == "fresh":
            mod._CACHE.clear()
        elif step[0] == "write":
            with open(path, "w") as f:
                f.write(step[1].replace("CARD", card))
        else:
            _, kernel, shape, dtype, heur, cands, timings = step
            meas = None if timings is None else CountingMeasure(timings)
            got = mod.resolve(kernel, shape, dtype, heur, cands, meas)
            seen.append((got, type(got).__name__,
                         None if meas is None else sorted(meas.calls)))
    reg = None
    if os.path.exists(path):
        with open(path) as f:
            try:
                raw = json.load(f)
            except ValueError:
                raw = "unreadable"
        reg = raw if isinstance(raw, str) else {
            k.rsplit("|", 1)[0]: {f: v for f, v in e.items()
                                  if f != "recorded_unix"}
            for k, e in raw.items()}
        if isinstance(raw, dict):
            assert all(k.rsplit("|", 1)[1] == card for k in raw), raw
    leftovers = [p for p in os.listdir(os.path.dirname(path))
                 if p.startswith(".autotune_")]
    return {"seen": seen, "counters": dict(mod.counters), "registry": reg,
            "leftovers": leftovers}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_resolver_matches_jax(name, tmp_path, env):
    def warns():
        return pytest.warns(UserWarning, match="unreadable") \
            if name == "corrupt_file" else contextlib.nullcontext()
    with warns():
        want = run_script(jat, SCRIPTS[name], str(tmp_path / "jax.json"),
                          env)
    with warns():
        got = run_script(tat, SCRIPTS[name], str(tmp_path / "torch.json"),
                         env)
    assert got == want
    assert got["leftovers"] == []


def test_disabled_reads_no_registry(tmp_path, env):
    path = tmp_path / "reg.json"
    path.write_text("{ not json")
    env.setenv("DS_AUTOTUNE_REGISTRY", str(path))
    env.setenv("DS_AUTOTUNE", "0")
    tat.reset()
    assert not tat.enabled() and not tat.search_allowed()
    assert tat.resolve("k", (1,), "float32", 7, (7, 8),
                       CountingMeasure({8: 0.1})) == 7
    assert tat._CACHE == {} and tat.counters["heuristic"] == 1


def test_decisions_kept_for_the_process(tmp_path, env):
    """A key decided once (searched or read) is not read again in this
    process: every later resolve is a hit, whatever the file holds now;
    ``reset()`` drops the decisions."""
    path = tmp_path / "reg.json"
    env.setenv("DS_AUTOTUNE_REGISTRY", str(path))
    tat.reset()
    meas = CountingMeasure({32: 0.01, 64: 0.02})
    assert tat.resolve("k", (2, 2), "float32", 64, (32, 64), meas) == 32
    path.write_text(json.dumps({"k|float32[2,2]|cpu": {"tile": 64}}))
    tat._CACHE.clear()
    for _ in range(3):
        assert tat.resolve("k", (2, 2), "float32", 64, (32, 64),
                           CountingMeasure({})) == 32
    assert tat.counters == {"search": 1, "hit": 3, "heuristic": 0}
    # another candidate set is another decision
    assert tat.resolve("k", (2, 2), "float32", 64, (16, 64),
                       CountingMeasure({})) == 64
    tat.reset()
    assert tat.resolve("k", (2, 2), "float32", 64, (32, 64),
                       CountingMeasure({})) == 64


def test_key_matches_jax_apart_from_card(env):
    for kernel, shape, dt in (("grouped_gemm", (8, 2560, 768, 3072, 1, 0, 0),
                               "bfloat16"),
                              ("sparse_flash", (24, 4096, 64, 12, 32, 32,
                                                528, 1), "bfloat16")):
        j = jat._key(kernel, shape, dt).rsplit("|", 1)[0]
        assert tat._key(kernel, shape, dt).rsplit("|", 1)[0] == j
        assert tat._key(kernel, shape, torch.bfloat16).rsplit("|", 1)[0] == j
    assert tat.card_kind() == "cpu" == jat.chip_kind()


@pytest.mark.parametrize("lo,hi,fits", [
    (16, 256, None), (16, 256, "le64"), (200, 100, None), (1, 1, None),
    (3, 100, None), (0, 64, None), (8, 4096, "odd_log2"), (64, 64, None)])
def test_pow2_candidates_match_jax(lo, hi, fits):
    pred = {None: None, "le64": lambda c: c <= 64,
            "odd_log2": lambda c: c.bit_length() % 2 == 0}[fits]
    assert tat.pow2_candidates(lo, hi, pred) == \
        jat.pow2_candidates(lo, hi, pred)


def test_measure_from_runner_times_warm_calls():
    calls = []
    measure = tat.measure_from_runner(lambda t: calls.append(t), repeats=3)
    t = measure(128)
    assert calls == [128] * 4 and 0.0 <= t < 1.0


# --------------------------------------------------------------------- #
# The call sites
# --------------------------------------------------------------------- #
GG_SHAPES = [(8, 2560, 768, 3072, "gelu_tanh"), (8, 2560, 3072, 768, None),
             (8, 2560, 768, 3072, None), (2, 128, 64, 96, None),
             (16, 64, 128, 512, "gelu_exact"), (1, 8192, 768, 768, None)]


@pytest.mark.parametrize("E,M,K,N,act", GG_SHAPES)
def test_k9_bn_is_gg_tile_when_disabled(E, M, K, N, act, env):
    env.setenv("DS_AUTOTUNE", "0")
    a = torch.empty(E, M, K, dtype=torch.bfloat16)
    b = torch.empty(E, K, N, dtype=torch.bfloat16)
    plan = tgg._gg_plan(a, b, act)
    assert plan.tile == (tgg.GG_BM, tgg._gg_tile(E, M, N, act))
    # a pinned BN passes the resolver by
    assert tgg._gg_plan(a, b, act, tile=128).tile[1] == 128


def test_k9_bn_hits_the_registry(tmp_path, env):
    env.setenv("DS_AUTOTUNE_REGISTRY", str(tmp_path / "reg.json"))
    tat.reset()
    E, M, K, N = 8, 2560, 768, 3072
    a = torch.empty(E, M, K, dtype=torch.bfloat16)
    b = torch.empty(E, K, N, dtype=torch.bfloat16)
    heur = tgg._gg_tile(E, M, N, None)
    # no search off the card (no measure), no record
    assert tgg._gg_plan(a, b).tile[1] == heur
    assert tat.counters == {"search": 0, "hit": 0, "heuristic": 1}
    other = 128 if heur == 256 else 256
    key = f"grouped_gemm|bfloat16[{E},{M},{K},{N},0,0,0]|cpu"
    (tmp_path / "reg.json").write_text(json.dumps({key: {"tile": other}}))
    tat.reset()
    assert tgg._gg_plan(a, b).tile[1] == other
    assert tat.counters["hit"] == 1
    # another layout of the operands (a M-major: a transposed view) is
    # another key
    at = torch.zeros(E, K, M, dtype=torch.bfloat16,
                     device="cpu").transpose(1, 2)
    assert tgg._gg_plan(at, b).tile[1] == heur


def _fixed_layout(nH=4, nb=16):
    lay = np.zeros((nH, nb, nb), np.int32)
    for i in range(nb):
        lay[:, i, max(0, i - 3):i + 1] = 1
        lay[:, i, :1] = 1
    return lay


@pytest.mark.parametrize("causal", [True, False])
def test_sparse_tile_is_pick_tile_when_disabled(causal, env):
    env.setenv("DS_AUTOTUNE", "0")
    lay = _fixed_layout()
    q = torch.zeros(2, 16 * 128, 4, 64, dtype=torch.bfloat16, device="cpu")
    assert tsf.resolve_tile(lay, 128, q=q, causal=causal) == \
        tsf.pick_tile(lay, block=128)


def test_sparse_tile_hits_the_registry_and_env_pins(tmp_path, env):
    env.setenv("DS_AUTOTUNE_REGISTRY", str(tmp_path / "reg.json"))
    tat.reset()
    lay = _fixed_layout()
    q = torch.zeros(2, 16 * 128, 4, 64, dtype=torch.bfloat16, device="cpu")
    heur = tsf.pick_tile(lay, block=128)
    assert tsf.resolve_tile(lay, 128, q=q, causal=True) == heur
    nnz = int((lay != 0).sum())
    key = f"sparse_flash|bfloat16[8,2048,64,4,16,16,{nnz},1]|cpu"
    pick = (2, 4) if heur != (2, 4) else (1, 2)
    (tmp_path / "reg.json").write_text(json.dumps({key: {"tile":
                                                         list(pick)}}))
    tat.reset()
    assert tsf.resolve_tile(lay, 128, q=q, causal=True) == pick
    assert tat.counters["hit"] == 1
    # the JAX package's overrides pin the tile past the resolver
    env.setenv("DS_SPARSE_WIDEN", "4")
    assert tsf.resolve_tile(lay, 128, q=q, causal=True) == (1, 4)
    assert tat.counters["hit"] == 1
    # without q (no key): pick_tile
    env.delenv("DS_SPARSE_WIDEN")
    assert tsf.resolve_tile(lay, 128) == heur


@pytest.mark.parametrize("autotune_on", ["0", "1"])
def test_paged_splits_stay_fixed(autotune_on, env):
    """K10's split count is not behind the resolver (the merge order,
    and with it the bits, depends on it): ``paged_splits`` either way,
    and a CPU call touches no counter."""
    env.setenv("DS_AUTOTUNE", autotune_on)
    tat.reset()
    assert [tpa.paged_splits(*a) for a in ((8, 12, 64, 1), (8, 12, 64, 4),
                                           (1, 12, 64, 32))] == [3, 3, 11]
    G, Q, K, nH, D, B, bs, J = 1, 2, 1, 2, 32, 8, 16, 4
    q = torch.randn(G, Q, K, nH, D)
    pool = torch.randn(G, B, nH, bs, D)
    bt = torch.arange(G * Q * J, dtype=torch.int32).reshape(G, Q, J) % B
    pos = torch.full((G, Q, K), 40, dtype=torch.int32)
    out = tpa.paged_attention(q, pool, pool, bt, pos, 0.125)
    again = tpa.paged_attention(q, pool, pool, bt, pos, 0.125, _splits=2)
    assert torch.equal(out, again)        # the plain version on the CPU
    assert tat.counters == {"search": 0, "hit": 0, "heuristic": 0}
