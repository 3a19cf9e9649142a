"""The port's serving leftovers against the JAX package, on gpt2-tiny in
fp32 with the same weights: the goodput ledger and SLO tracker
(``monitor/serving_slo.py``) and the aggregator's ``attend`` section and
``merged``; int8 and bf16 weight quantization (``inference/
quantize.py``); the slot-major cache (``block_size: 0``); the replica
router (``inference/router.py``).

The JAX engines run on a one-device mesh with ``paged_kernel: false``
where they page (ROADMAP R2). Tolerances: the ledger, tracker and
aggregator snapshots EQUAL for the same notes and clocks; int8 scales and
``dequantize`` bit-equal, every ``q`` within one grid step of
``w / scale``; bf16 rounding to one of the two bf16 neighbours, its mean
error over 10^5 draws within 4 sigma of 0; step logits within the
serving tests' atol 1e-4 and greedy streams EQUAL (int8 from the JAX
package's quantized tree, slot-major, the router); the router's route
choices and replica assignments equal. Noise bits of the stochastic
roundings cannot match JAX's threefry bits, so the quantizers are held
to the rules, not to JAX's draws.
"""
import dataclasses
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import ReplicaRouter as JRouter
from deepspeed_tpu.inference import quantize as jquant
from deepspeed_tpu.inference import scheduler as jsched
from deepspeed_tpu.models.gpt2 import GPT2_CONFIGS as JCONFIGS
from deepspeed_tpu.models.gpt2 import gpt2_init as jgpt2_init
from deepspeed_tpu.monitor import serving as jserving
from deepspeed_tpu.monitor import serving_slo as jslo
from deepspeed_tpu.ops import stochastic_rounding as jsr
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.inference import InferenceEngine as TEngine
from deepspeed_tpu_torch.inference import ReplicaRouter as TRouter
from deepspeed_tpu_torch.inference import kv_cache as tkv
from deepspeed_tpu_torch.inference import quantize as tquant
from deepspeed_tpu_torch.inference import scheduler as tsched
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS
from deepspeed_tpu_torch.monitor import serving as tserving
from deepspeed_tpu_torch.monitor import serving_slo as tslo
from deepspeed_tpu_torch.ops import stochastic_rounding as tsr

JCFG = dataclasses.replace(JCONFIGS["gpt2-tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)
ATOL = 1e-4
INF = {"max_slots": 4, "max_seq_len": 64, "prefill_chunk": 8,
       "block_size": 8}
# A TTFT target no request misses and a TPOT target every multi-token
# request misses: the tracker's counts do not depend on the clocks.
SLO = {"ttft_ms": 1e9, "tpot_ms": 1e-6, "availability": 0.9,
       "window_s": 3600.0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread for this module (gpt2-tiny's ops
    are small; parallel test workers' intra-op teams would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params_np():
    """JAX init with the matmul weights scaled up, so greedy streams vary
    token to token (as tests/test_torch_serving.py does)."""
    p = jax.tree_util.tree_map(np.asarray,
                               jgpt2_init(jax.random.PRNGKey(3), JCFG))
    for name in list(p["blocks"]):
        if name.endswith("_kernel"):
            p["blocks"][name] = p["blocks"][name] * 6
    p["wte"], p["wpe"] = p["wte"] * 6, p["wpe"] * 6
    return p


@pytest.fixture(scope="module")
def params_np():
    return _params_np()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _stream(mod, n=7):
    return mod.shared_prefix_requests(n, prefix_len=16, tail_len=(0, 6),
                                      max_new_tokens=6, vocab_size=512,
                                      seed=0)


def _jengine(tree, **inf):
    return JEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, tree),
                   config={"inference": dict(INF, paged_kernel=False,
                                             **inf)},
                   mesh=build_mesh(devices=jax.devices()[:1]))


def _tengine(tree, **inf):
    return TEngine(TCFG, convert.from_jax_params(tree),
                   config={"inference": dict(INF, **inf)}, device="cpu")


def _drive(eng):
    """Prefill two slots (cross-block and partial contexts), then five
    decode steps; returns per-step logits and tokens."""
    logits, toks = [], []
    for s, n in ((0, 11), (1, 17)):
        tok, lg = eng.prefill(_prompt(n, s), slot=s, return_logits=True)
        eng.activate_slot(s, n, tok)
        logits.append(np.asarray(lg))
        toks.append(int(tok))
    for _ in range(5):
        tok, lg = eng.decode_once(return_logits=True)
        logits.append(np.asarray(lg)[:2])
        toks.append([int(t) for t in np.asarray(tok)[:2]])
    for s in (0, 1):
        eng.release_slot(s)
    return logits, toks


def _serve(eng, mod):
    eng.reset_serving_stats()
    rep = eng.serve(_stream(mod))
    return rep, [r["tokens"] for r in rep["requests"]]


def _assert_steps_close(port, ref):
    (tl, tt), (jl, jt) = port, ref
    assert tt == jt
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


# --------------------------------------------------------------------- #
# The goodput ledger, the SLO tracker and the aggregator (host code)
# --------------------------------------------------------------------- #
class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _drive_overlays(slo_mod, ttft_ms, tpot_ms):
    clock = Clock()
    led = slo_mod.ServingGoodputLedger(label="r0", clock=clock)
    trk = slo_mod.SLOTracker(ttft_ms=ttft_ms, tpot_ms=tpot_ms,
                             availability=0.95, window_s=10.0, clock=clock)
    for i, (bucket, s) in enumerate((("prefill", 0.25), ("decode_useful",
                                     1.5), ("spec_wasted", 0.125),
                                     ("idle", 0.5), ("admission_blocked",
                                                     0.0625))):
        led.note(bucket, s)
        clock.t += 2.0
        trk.observe(0.010 * (i + 1), 0.004 * (i + 1))
    trk.observe(0.2, None)
    trk.observe_failure()
    clock.t += 9.0                   # the first outcomes leave the window
    trk.observe(0.001, 0.001)
    with pytest.raises(ValueError, match="unknown serving bucket"):
        led.note("decode", 1.0)
    snaps = (led.snapshot(), led.snapshot(wall_s=2.0), trk.snapshot())
    return led, trk, snaps


@pytest.mark.parametrize("targets", [(25.0, 0.0), (0.0, 9.0), (30.0, 13.0)])
def test_ledger_and_slo_tracker_match_jax(targets):
    """F4's host half: the same notes and clocks give the same ledger
    and tracker snapshots, and the same merged views."""
    tl, tt, tsnaps = _drive_overlays(tslo, *targets)
    jl, jt, jsnaps = _drive_overlays(jslo, *targets)
    assert tsnaps == jsnaps
    assert tsnaps[1]["consistent"] is False      # 2.4375 s noted in 2 s
    assert tsnaps[0]["consistent"] is True
    assert tslo.ServingGoodputLedger.merged([tsnaps[0], tsnaps[0]]) == \
        jslo.ServingGoodputLedger.merged([jsnaps[0], jsnaps[0]])
    assert tslo.SLOTracker.merged([tt, tt]) == \
        jslo.SLOTracker.merged([jt, jt])
    assert tslo.SERVING_BUCKETS == jslo.SERVING_BUCKETS
    for mod in (tslo, jslo):
        with pytest.raises(ValueError, match="availability"):
            mod.SLOTracker(availability=1.0)


def _drive_aggregator(mod, slo_mod, label):
    agg = mod.ServingAggregator(4, label=label)
    agg.attend_mode = "kernel"
    clock = Clock()
    agg.ledger = slo_mod.ServingGoodputLedger(label=label, clock=clock)
    agg.slo = slo_mod.SLOTracker(ttft_ms=40.0, clock=clock)
    for i in range(5):
        agg.note_iteration(1 + i % 4, 0.003 + 0.001 * i,
                           cache_bytes=4096 * (i + 1),
                           context_tokens=10 + i, emitted_tokens=i + 1)
        agg.note_attend(1000 + i, 9000, 512 * (i + 1), 8192, i + 1)
        agg.ledger.note("decode_useful", 0.003 + 0.001 * i)
    agg.note_prefill(24)
    agg.note_admit(24, 16)
    agg.note_spec(12, 7)
    agg.note_reject()
    for i in range(3):
        ttft = (0.02 + 0.015 * i) if label == "a" else 0.1 * (i + 1)
        agg.note_request(ttft, 0.002 * (i + 1), 6, queue_wait_s=0.001 * i,
                         service_ttft_s=ttft - 0.001 * i,
                         admission_attempts=i)
        agg.slo.observe(ttft, 0.002 * (i + 1))
    return agg


def test_aggregator_snapshot_and_merged_match_jax():
    """The snapshot's keys and values (``attend``, ``ledger``, ``slo``
    included) and ``merged``'s pooled view equal JAX's for the same
    notes."""
    t = [_drive_aggregator(tserving, tslo, lb) for lb in ("a", "b")]
    j = [_drive_aggregator(jserving, jslo, lb) for lb in ("a", "b")]
    for a, b in zip(t, j):
        assert a.snapshot(wall_s=0.5) == b.snapshot(wall_s=0.5)
    tm, jm = tserving.ServingAggregator.merged(t), \
        jserving.ServingAggregator.merged(j)
    snap = tm.snapshot(wall_s=1.0)
    assert snap == jm.snapshot(wall_s=1.0)
    assert {"attend", "ledger", "slo", "prefix", "spec", "admission",
            "attend_work_ratio"} <= set(snap)
    assert snap["slo"]["replicas"] == 2 and snap["ledger"]["replicas"] == 2


def test_merged_pools_raw_samples():
    """``merged`` pools the replicas' raw samples: the fleet's p50 is the
    nearest-rank p50 of all six TTFTs (30 ms), not the mean of the two
    medians (110 ms)."""
    a = tserving.ServingAggregator(8, label="r0")
    b = tserving.ServingAggregator(8, label="r1")
    for ms in (10, 20, 30):
        a.note_request(ms / 1e3, None, 4)
    for ms in (100, 200, 300):
        b.note_request(ms / 1e3, None, 4)
    a.note_iteration(8, 0.01, cache_bytes=1000, context_tokens=10)
    b.note_iteration(4, 0.01, cache_bytes=3000, context_tokens=10)
    snap = tserving.ServingAggregator.merged([a, b]).snapshot(wall_s=1.0)
    assert snap["replica"] == "aggregate" and snap["completed"] == 6
    assert snap["ttft_ms"]["n"] == 6
    assert snap["ttft_ms"]["p50"] == tserving.percentile(
        [10.0, 20.0, 30.0, 100.0, 200.0, 300.0], 50) == 30.0
    assert snap["ttft_ms"]["p95"] == 300.0
    assert snap["hbm_bytes_per_token"]["n"] == 2
    assert snap["occupancy_mean"] == 0.75


# --------------------------------------------------------------------- #
# F4: an engine with inference.slo reports slo and ledger as JAX's does
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def slo_reports(params_np):
    jeng = _jengine(params_np, slo=SLO)
    jrep, jtoks = _serve(jeng, jsched)
    jeng.close()
    teng = _tengine(params_np, slo=SLO)
    trep, ttoks = _serve(teng, tsched)
    return (trep, ttoks), (jrep, jtoks)


def test_slo_and_ledger_reported_as_jax(slo_reports):
    (trep, ttoks), (jrep, jtoks) = slo_reports
    assert ttoks == jtoks
    assert set(trep) == set(jrep)
    assert "recompiles" in trep and "trace" not in trep
    assert set(trep["ledger"]) == set(jrep["ledger"])
    assert trep["ledger"]["consistent"] is True
    for rep in (trep, jrep):
        assert rep["ledger"]["decode_useful_s"] > 0
        assert rep["ledger"]["prefill_s"] > 0
    # Every request misses TPOT, none TTFT: counts independent of clocks.
    slo = {k: v for k, v in trep["slo"].items() if k != "window"}
    assert slo == {k: v for k, v in jrep["slo"].items() if k != "window"}
    assert trep["slo"]["window"] == jrep["slo"]["window"]
    assert trep["slo"]["total"] == 7 and trep["slo"]["attainment"] == 0.0
    assert trep["slo"]["burn_rate"] == pytest.approx(10.0)
    # attend: the same analytic work per token, priced from the same
    # contexts (the mode names the attend each engine ran).
    for key in ("flops_per_token", "hbm_bytes_per_token"):
        assert trep["attend"][key] == jrep["attend"][key]
    assert trep["attend_work_ratio"] == jrep["attend_work_ratio"]
    assert trep["attend"]["mode"] == "kernel"


def test_every_engine_carries_a_ledger(params_np):
    eng = _tengine(params_np)
    assert eng.serving.ledger is not None and eng.serving.slo is None
    rep = eng.serve(_stream(tsched, 3))
    assert rep["ledger"]["consistent"] is True and "slo" not in rep
    eng.abort_request(0)                     # no tracker: nothing to score
    eng = _tengine(params_np, slo=SLO)
    eng.abort_request(5, "max_wall")
    assert eng.serving.slo.snapshot()["failures"] == 1


# --------------------------------------------------------------------- #
# int8 and bf16 quantization
# --------------------------------------------------------------------- #
def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and not ("q" in v and "scale" in v):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def jax_int8(params_np):
    """The JAX int8 engine, which quantizes the fp32 tree with
    ``quantize_params(params, "int8", PRNGKey(17))`` (its default key):
    its stored tree, per-step logits, serve and ``param_bytes``."""
    jeng = _jengine(params_np, quantize="int8")
    jq = jax.tree_util.tree_map(np.asarray, jeng._params)
    out = (jq, _drive(jeng), _serve(jeng, jsched), jeng.param_bytes)
    jeng.close()
    return out


@pytest.fixture(scope="module")
def int8_trees(params_np, jax_int8):
    tq = tquant.quantize_params(convert.from_jax_params(params_np), "int8",
                                seed=17)
    return jax_int8[0], tq


def test_int8_scales_bit_equal_and_q_within_a_step(params_np, int8_trees):
    jq, tq = int8_trees
    jl, tl, wl = _leaves(jq), _leaves(tq), _leaves(params_np)
    assert sorted(jl) == sorted(tl)
    quantized = sorted(k for k, v in jl.items() if isinstance(v, dict))
    # The ndim >= 2 rule takes the stacked [L, H] vectors too (R3):
    # only ln_f stays fp32.
    assert sorted(set(jl) - set(quantized)) == ["ln_f_bias", "ln_f_scale"]
    assert "blocks/ln1_scale" in quantized and "blocks/fc_bias" in quantized
    for name in quantized:
        j, t, w = jl[name], tl[name], wl[name]
        assert t["q"].dtype == torch.int8 and t["scale"].dtype == \
            torch.float32
        assert tuple(t["q"].shape) == j["q"].shape == w.shape
        assert tuple(t["scale"].shape) == j["scale"].shape == \
            (1,) * (w.ndim - 1) + (w.shape[-1],)
        np.testing.assert_array_equal(t["scale"].numpy(), j["scale"])
        x = w / j["scale"]
        q = t["q"].numpy().astype(np.float32)
        assert np.all((q >= np.floor(x) - 0) & (q <= np.ceil(x))
                      | (np.abs(q) == 127)), name
        assert np.abs(q - x).max() < 1.0, name
    np.testing.assert_array_equal(tl["ln_f_scale"].numpy(),
                                  jl["ln_f_scale"])
    assert tquant.quantized_bytes(tq) == jquant.quantized_bytes(jq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bit_equal_to_jax(int8_trees, dtype):
    jq, _ = int8_trees
    jd = jquant.dequantize(jax.tree_util.tree_map(jnp.asarray, jq),
                           getattr(jnp, dtype))
    td = tquant.dequantize(convert.from_jax_params(jq), getattr(torch, dtype))
    jl, tl = _leaves(jd), _leaves(td)
    assert sorted(jl) == sorted(tl)
    for name in jl:
        j = np.asarray(jl[name].astype(jnp.float32))
        t = tl[name].float().numpy()
        assert tl[name].dtype == getattr(torch, dtype if name[:4] != "ln_f"
                                         else "float32"), name
        np.testing.assert_array_equal(t, j, err_msg=name)


def test_int8_passes_quantized_leaves_through(int8_trees):
    _, tq = int8_trees
    again = tquant.quantize_params(tq, "int8", seed=3)
    for name, leaf in _leaves(tq).items():
        assert _leaves(again)[name] is leaf


def _bf16_neighbours(x):
    """The two bf16 values around fp32 ``x`` (truncation and one ulp
    up), as fp32."""
    bits = x.view(np.uint32) & np.uint32(0xFFFF0000)
    lo = bits.view(np.float32)
    hi = (bits + np.uint32(0x10000)).view(np.float32)
    return lo, hi


def test_bf16_rounds_to_a_neighbour_and_keeps_inf_nan(params_np):
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    x[:4] = [np.inf, -np.inf, np.nan, 0.0]
    t = tsr.stochastic_round_bf16(torch.from_numpy(x),
                                  torch.Generator().manual_seed(0))
    j = np.asarray(jsr.stochastic_round_bf16(jnp.asarray(x),
                                             jax.random.PRNGKey(0)))
    assert t.dtype == torch.bfloat16
    tf, jf = t.float().numpy(), j.astype(np.float32)
    assert np.isposinf(tf[0]) and np.isneginf(tf[1]) and np.isnan(tf[2])
    lo, hi = _bf16_neighbours(np.abs(x[3:]))
    sign = np.sign(x[3:])
    for got in (tf[3:], jf[3:]):
        assert np.all((np.abs(got) == lo) | (np.abs(got) == hi))
        assert np.all((np.sign(got) == sign) | (got == 0))
    # The bf16 engine mode: every float leaf, each a neighbour.
    tq = tquant.quantize_params(convert.from_jax_params(params_np), "bf16",
                                seed=1)
    for name, leaf in _leaves(tq).items():
        w = np.abs(_leaves(params_np)[name])
        assert leaf.dtype == torch.bfloat16, name
        lo, hi = _bf16_neighbours(w)
        got = np.abs(leaf.float().numpy())
        assert np.all((got == lo) | (got == hi)), name


def test_bf16_rounding_is_unbiased():
    """10^5 draws of one value a quarter ulp above a bf16 value: the mean
    error within 4 sigma of 0 (sigma = ulp * sqrt(p (1-p) / n))."""
    n, ulp = 100_000, 2.0 ** -7
    x = np.full(n, 1.0 + ulp / 4, np.float32)
    t = tsr.stochastic_round_bf16(torch.from_numpy(x),
                                  torch.Generator().manual_seed(11))
    err = t.float().numpy().astype(np.float64) - x.astype(np.float64)
    sigma = ulp * np.sqrt(0.25 * 0.75 / n)
    assert abs(err.mean()) < 4 * sigma
    assert 0.2 < (err > 0).mean() < 0.3


@pytest.fixture(scope="module")
def int8_engines(jax_int8):
    """The JAX int8 engine and the port's, fed JAX's quantized tree
    through ``from_jax_params``."""
    jq = jax_int8[0]
    out = {"jax": jax_int8[1:]}
    teng = _tengine(jq, quantize="int8")
    out["port"] = (_drive(teng), _serve(teng, tsched), teng.param_bytes)
    out["port_engine"] = teng
    return out


def test_int8_engine_matches_jax(int8_engines):
    (tsteps, (trep, ttoks), tbytes) = int8_engines["port"]
    (jsteps, (jrep, jtoks), jbytes) = int8_engines["jax"]
    _assert_steps_close(tsteps, jsteps)
    assert ttoks == jtoks and trep["completed"] == 7
    assert tbytes == jbytes
    teng = int8_engines["port_engine"]
    assert teng._params["blocks"]["qkv_kernel"]["q"].dtype == torch.int8


def test_bf16_engine_serves_at_half_the_bytes(params_np):
    eng = _tengine(params_np, quantize="bf16")
    fp32 = sum(v.nbytes for v in _leaves(params_np).values())
    vectors = sum(v.nbytes for k, v in _leaves(params_np).items()
                  if not (k.endswith("_kernel") or k in (
                      "wte", "wpe", "blocks/qkv_bias", "blocks/proj_bias",
                      "blocks/fc_out_bias")))
    # bf16 at rest; the vectors the kernels read in fp32 widened once.
    assert eng.param_bytes == (fp32 - vectors) // 2 + vectors
    assert eng._params["blocks"]["fc_kernel"].dtype == torch.bfloat16
    rep = eng.serve(_stream(tsched, 3))
    assert rep["completed"] == 3


# --------------------------------------------------------------------- #
# The slot-major cache (block_size: 0)
# --------------------------------------------------------------------- #
SLOT_MAJOR = {"block_size": 0}


@pytest.fixture(scope="module")
def slot_major(params_np):
    jeng = _jengine(params_np, **SLOT_MAJOR)
    out = {"jax": (_drive(jeng), _serve(jeng, jsched),
                   jeng.cache_spec.nbytes())}
    jeng.close()
    teng = _tengine(params_np, **SLOT_MAJOR)
    out["port"] = (_drive(teng), _serve(teng, tsched),
                   teng.cache_spec.nbytes())
    out["paged"] = _serve(_tengine(params_np), tsched)
    return out


def test_slot_major_matches_jax(slot_major):
    (tsteps, (trep, ttoks), tbytes) = slot_major["port"]
    (jsteps, (jrep, jtoks), jbytes) = slot_major["jax"]
    _assert_steps_close(tsteps, jsteps)
    assert ttoks == jtoks
    assert set(trep) == set(jrep)
    assert "recompiles" in trep and "trace" not in trep
    assert "prefix" not in trep and "attend" not in trep
    for key in ("decode_tokens", "prefill_tokens", "iterations",
                "completed", "cache_bytes_p95"):
        assert trep[key] == jrep[key], key
    assert trep["cache_bytes_p95"] == tbytes == jbytes


def test_slot_major_streams_equal_paged(slot_major):
    assert slot_major["port"][1][1] == slot_major["paged"][1]


def test_slot_major_whole_prompt_equals_paged_whole_prompt(params_np):
    eng = _tengine(params_np, block_size=0, prefill_chunk=0)
    assert eng.prefix_match_tokens(_prompt(20, 1)) == 0
    _, toks = _serve(eng, tsched)
    _, paged = _serve(_tengine(params_np, prefill_chunk=0), tsched)
    assert toks == paged
    with pytest.raises(RuntimeError, match="chunked prefill"):
        eng.prefill_many([(0, _prompt(5, 0), 4)])


def test_slot_major_rows_hold_the_jax_cache(params_np):
    """After a prefill the slot's rows in the pool layout read back as
    the JAX slot-major cache's ``slot_rows``; odd capacities take a
    smaller pool block."""
    jeng = _jengine(params_np, **SLOT_MAJOR)
    teng = _tengine(params_np, **SLOT_MAJOR)
    prompt = _prompt(13, 9)
    for eng in (jeng, teng):
        eng.prefill(prompt, slot=2)
    spec = teng.cache_spec
    for layer in (0, JCFG.num_layers - 1):
        for part in ("k", "v"):
            got = tkv.slot_rows(teng.cache[part][layer], spec, 2)[:, :13]
            want = np.asarray(jeng.cache[part][layer, 2])[:, :13]
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    jeng.close()
    odd = tkv.KVCacheSpec(2, 3, 2, 60, 32, torch.float32)
    assert odd.pool_block == 4 and odd.slot_tables().shape == (3, 15)
    assert odd.pool_spec().nbytes() == odd.nbytes()


# --------------------------------------------------------------------- #
# The replica router
# --------------------------------------------------------------------- #
def test_route_makes_jax_choices(params_np):
    """The prefix holder wins over an idle replica; with affinity 0 the
    idle one does (JAX's test_affinity_routes_to_prefix_holder, both
    packages on the same engine states)."""
    prompt = _prompt(24, seed=16)
    choices = {}
    for name, make, router_cls, req_cls in (
            ("jax", _jengine, JRouter, jsched.Request),
            ("port", _tengine, TRouter, tsched.Request)):
        engines = [make(params_np, max_slots=8) for _ in range(2)]
        tok, _ = engines[1].prefill(prompt, slot=0)
        engines[1].activate_slot(0, len(prompt), tok)
        got = []
        for w in (1.0, 0.0):
            router = router_cls(engines, affinity_weight=w)
            req = req_cls(rid=0, prompt=prompt, max_new_tokens=4)
            got.append((router.route(req, [deque(), deque()]),
                        router.affinity_hits, router.decisions))
        choices[name] = got
        for e in engines:
            if hasattr(e, "mesh"):
                e.close()
    assert choices["port"] == choices["jax"]
    assert [c[0] for c in choices["port"]] == [1, 0]


@pytest.fixture(scope="module")
def router_reports(params_np):
    reps = {}
    for name, make, router_cls, mod in (
            ("jax", _jengine, JRouter, jsched),
            ("port", _tengine, TRouter, tsched)):
        engines = [make(params_np, replica=f"r{i}", slo=SLO)
                   for i in range(2)]
        reps[name] = router_cls(engines).serve(_stream(mod, 9))
        for e in engines:
            if hasattr(e, "mesh"):
                e.close()
    return reps


def test_router_streams_equal_jax(router_reports):
    t, j = router_reports["port"], router_reports["jax"]
    assert [(r["rid"], r["replica"], r["tokens"]) for r in t["requests"]] \
        == [(r["rid"], r["replica"], r["tokens"]) for r in j["requests"]]
    assert t["router"] == j["router"]
    assert min(t["router"]["routed"]) > 0
    assert set(t) == set(j)
    assert t["recompiles"] == j["recompiles"] == 0 and "trace" not in t
    assert t["completed"] == 9 and t["unfinished"] == 0
    assert t["prefix"] == j["prefix"] and t["prefix"]["hit_rate"] > 0
    assert [r["replica"] for r in t["replicas"]] == ["r0", "r1"]
    for rep in t["replicas"]:
        assert rep["ledger"]["consistent"] is True
    assert t["slo"]["replicas"] == 2 and t["slo"]["total"] == 9
    assert t["slo"] == {**j["slo"], "window": t["slo"]["window"]}
    assert t["ttft_ms"]["n"] == 9


def test_router_never_admittable_raises_as_jax(params_np):
    msgs = []
    for make, router_cls, mod in ((_jengine, JRouter, jsched),
                                  (_tengine, TRouter, tsched)):
        # 20 + 8 tokens need 4 blocks of 8; each pool holds 3.
        engines = [make(params_np, max_slots=8, num_blocks=3)
                   for _ in range(2)]
        reqs = [mod.Request(rid=0, prompt=_prompt(20, seed=30),
                            max_new_tokens=8)]
        with pytest.raises(RuntimeError, match="never be admitted") as e:
            router_cls(engines).serve(reqs)
        msgs.append(str(e.value))
        for e in engines:
            if hasattr(e, "mesh"):
                e.close()
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("front", ["router", "scheduler"])
def test_max_wall_aborts_count_against_the_slo_as_jax(params_np, monkeypatch,
                                                      front):
    """``max_wall_s`` abandons the serve after the first decode step: the
    slots in flight abort as ``max_wall``, the queued requests as
    ``starved``, and each counts as an SLO failure — the same counts as
    the JAX front end's, under the same step-driven clock."""
    import types
    from deepspeed_tpu.inference import router as jrouter_mod
    from deepspeed_tpu_torch.inference import router as trouter_mod
    reports = []
    for make, mod, fmod in ((_jengine, jsched, jrouter_mod),
                            (_tengine, tsched, trouter_mod)):
        fmod = fmod if front == "router" else mod
        late = []                       # the clock jumps after a decode
        monkeypatch.setattr(fmod, "time", types.SimpleNamespace(
            perf_counter=lambda: 1e6 if late else 0.0, sleep=lambda s: 0))
        engines = [make(params_np, slo=SLO)]
        decode = engines[0].decode_once

        def decode_once(*a, decode=decode, late=late, **k):
            late.append(1)
            return decode(*a, **k)
        engines[0].decode_once = decode_once
        reqs = _stream(mod, 6)
        if front == "router":
            rep = (JRouter if mod is jsched else TRouter)(
                engines, max_wall_s=1.0).serve(reqs)
            slo = rep["slo"]
        else:
            rep = engines[0].serve(reqs, max_wall_s=1.0)
            slo = rep["slo"]
        reports.append((rep["unfinished"], rep["completed"],
                        {k: slo[k] for k in ("total", "good", "failures")}))
        assert not engines[0].active.any()
        for e in engines:
            if hasattr(e, "mesh"):
                e.close()
    assert reports[0] == reports[1], reports
    unfinished, completed, counts = reports[1]
    # Every request failed; the report's ``unfinished`` keeps the queued
    # (starved) ones, the aborted slots having been released.
    assert completed == 0 and counts["good"] == 0
    assert counts["total"] == counts["failures"] == len(reqs)
    assert 0 < unfinished < len(reqs)
