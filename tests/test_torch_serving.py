"""The port's serving slice as a whole (deepspeed_tpu_torch/inference)
against the JAX engine, on gpt2-tiny in fp32 with the same weights.

The JAX engine runs on a one-device mesh with ``paged_kernel: false``
(its kernel-on engine is a known reference fault, ROADMAP R2); the
port's paged-attention function itself is held against the JAX kernel
in tests/test_torch_paged_attention.py. Per-step prefill and decode
logits agree within atol 1e-4; greedy token streams through ``serve()``
are EQUAL; and in the port ``spec_k: 3`` gives the same greedy streams
as ``spec_k: 0``. With ``gelu_exact`` (the erf form) the step logits
agree within 1e-4 too, and the MLP up-projection within 2e-6 (+ 1e-6
relative) of JAX's ``gelu_dense_fn``. The same holds for whole-prompt prefill
(``prefill_chunk: 0``: both engines share no prefix and, on the CPU,
attend densely at max_seq_len 64). ``gpt2_prefill_full_paged`` itself,
with flash attention on both sides (the JAX Pallas forward in interpret
mode, the port's plain version) at T = 128, gives logits within atol
1e-4 and written K/V pools within atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import decode as jdecode
from deepspeed_tpu.inference import scheduler as jsched
from deepspeed_tpu.models.gpt2 import GPT2_CONFIGS as JCONFIGS
from deepspeed_tpu.models.gpt2 import gpt2_init as jgpt2_init
from deepspeed_tpu.models import transformer as jtr
from deepspeed_tpu.ops.flash_attention import flash_attention as jflash
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.inference import InferenceEngine as TEngine
from deepspeed_tpu_torch.inference import decode as tdecode
from deepspeed_tpu_torch.inference import scheduler as tsched
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS
from deepspeed_tpu_torch.ops.flash_attention import flash_attention as tflash

JCFG = dataclasses.replace(JCONFIGS["gpt2-tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)
ATOL = 1e-4
INF = {"max_slots": 4, "max_seq_len": 64, "prefill_chunk": 8,
       "block_size": 8}
STREAMS = {
    "synthetic": lambda mod: mod.synthetic_requests(
        6, prompt_len=(5, 20), max_new_tokens=6, vocab_size=512, seed=1),
    # prefix of 2 full blocks; empty tails make exact-chain prompts that
    # fork their last shared block copy-on-write
    "shared_prefix": lambda mod: mod.shared_prefix_requests(
        7, prefix_len=16, tail_len=(0, 6), max_new_tokens=6,
        vocab_size=512, seed=0),
}


def _params_np():
    """JAX init with the matmul weights scaled up, so greedy streams vary
    token to token (the default 0.02 init decodes near-constant)."""
    p = jax.tree_util.tree_map(np.asarray,
                               jgpt2_init(jax.random.PRNGKey(3), JCFG))
    for name in list(p["blocks"]):
        if name.endswith("_kernel"):
            p["blocks"][name] = p["blocks"][name] * 6
    p["wte"], p["wpe"] = p["wte"] * 6, p["wpe"] * 6
    return p


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


def _drive(eng):
    """Prefill two slots (cross-block and partial contexts), then six
    decode steps; returns per-step logits and tokens."""
    logits, toks = [], []
    for s, n in ((0, 11), (1, 17)):
        tok, lg = eng.prefill(_prompt(n, s), slot=s, return_logits=True)
        eng.activate_slot(s, n, tok)
        logits.append(np.asarray(lg))
        toks.append(int(tok))
    for _ in range(6):
        tok, lg = eng.decode_once(return_logits=True)
        logits.append(np.asarray(lg)[:2])
        toks.append([int(t) for t in np.asarray(tok)[:2]])
    return logits, toks


def _serve(eng, mod, stream):
    eng.reset_serving_stats()
    rep = eng.serve(STREAMS[stream](mod))
    return rep, [r["tokens"] for r in rep["requests"]]


@pytest.fixture(scope="module")
def params_np():
    return _params_np()


@pytest.fixture(scope="module")
def jax_results(params_np):
    """Everything the JAX engine is compared on, from ONE engine (its
    compiled programs are the slow part on the CPU)."""
    eng = JEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, params_np),
                  config={"inference": dict(INF, paged_kernel=False)},
                  mesh=build_mesh(devices=jax.devices()[:1]))
    out = {"steps": _drive(eng)}
    for s in (0, 1):
        eng.release_slot(s)
    for stream in STREAMS:
        out[stream] = _serve(eng, jsched, stream)
    out["cow_copies"] = eng.allocator.cow_copies
    eng.close()
    return out


def _port_engine(params_np, **inf):
    return TEngine(TCFG, convert.from_jax_params(params_np),
                   config={"inference": dict(INF, **inf)}, device="cpu")


@pytest.fixture(scope="module")
def port_results(params_np):
    eng = _port_engine(params_np)
    out = {"steps": _drive(eng)}
    for s in (0, 1):
        eng.release_slot(s)
    for stream in STREAMS:
        out[stream] = _serve(eng, tsched, stream)
    out["cow_copies"] = eng.allocator.cow_copies
    return out


def test_step_logits_match_jax(jax_results, port_results):
    (jl, jt), (tl, tt) = jax_results["steps"], port_results["steps"]
    assert tt == jt
    assert len(tl) == len(jl) == 8
    for a, b in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_step_logits_match_jax_gelu_exact(params_np):
    """``gelu_exact=True`` (the erf form) in both engines: the per-step
    prefill and decode logits within ATOL and the same greedy tokens."""
    jcfg = dataclasses.replace(JCFG, gelu_exact=True)
    tcfg = dataclasses.replace(TCFG, gelu_exact=True)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params_np),
                   config={"inference": dict(INF, paged_kernel=False)},
                   mesh=build_mesh(devices=jax.devices()[:1]))
    jl, jt = _drive(jeng)
    jeng.close()
    teng = TEngine(tcfg, convert.from_jax_params(params_np),
                   config={"inference": INF}, device="cpu")
    tl, tt = _drive(teng)
    assert tt == jt
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_gelu_dense_fn_exact_matches_jax(params_np, fused):
    """The block's MLP up-projection, ``gelu_dense_fn(cfg)`` with
    ``gelu_exact=True``, against JAX's (``jax.nn.gelu(approximate=
    False)``, or the Pallas kernel in interpret mode where ``fused``)
    within 2e-6 absolute plus 1e-6 relative: XLA's fp32 erf (see
    test_torch_fused_elementwise.py) and two fp32 matmul orders (1.9e-6
    apart at |out| 5.6, where the tanh form reads 4.7e-4 apart)."""
    jcfg = dataclasses.replace(JCFG, gelu_exact=True, fused_kernels=fused)
    tcfg = dataclasses.replace(TCFG, gelu_exact=True)
    blk = params_np["blocks"]
    h = np.random.default_rng(5).standard_normal(
        (3, 7, JCFG.hidden_size)).astype(np.float32)
    kern, bias = blk["fc_kernel"][0], blk["fc_bias"][0] + 0.5
    ref = np.asarray(jtr.gelu_dense_fn(jcfg)(
        jnp.asarray(h), jnp.asarray(kern), jnp.asarray(bias)))
    out = tdecode.gelu_dense_fn(tcfg)(
        torch.from_numpy(h), torch.from_numpy(kern), torch.from_numpy(bias))
    assert np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_serve_greedy_streams_equal_jax(stream, jax_results, port_results):
    (jrep, jtoks), (trep, ttoks) = jax_results[stream], port_results[stream]
    assert trep["completed"] == jrep["completed"] == len(ttoks)
    assert trep["unfinished"] == 0
    assert ttoks == jtoks
    assert len({t for r in ttoks for t in r}) > len(ttoks)   # varied
    for key in ("decode_tokens", "prefill_tokens", "iterations"):
        assert trep[key] == jrep[key], key
    if stream == "shared_prefix":
        assert trep["prefix"] == jrep["prefix"]
        assert trep["prefix"]["hit_rate"] > 0


def test_prefix_hits_fork_copy_on_write(jax_results, port_results):
    assert port_results["cow_copies"] == jax_results["cow_copies"] > 0


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_spec_k3_streams_equal_plain(stream, params_np, port_results):
    eng = _port_engine(params_np, spec_k=3)
    rep, toks = _serve(eng, tsched, stream)
    assert toks == port_results[stream][1]
    assert rep["spec"]["proposed"] > 0


# --------------------------------------------------------------------- #
# Whole-prompt prefill (prefill_chunk: 0)
# --------------------------------------------------------------------- #
WHOLE = {"prefill_chunk": 0}


@pytest.fixture(scope="module")
def jax_whole(params_np):
    eng = JEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, params_np),
                  config={"inference": dict(INF, paged_kernel=False,
                                            **WHOLE)},
                  mesh=build_mesh(devices=jax.devices()[:1]))
    out = {"steps": _drive(eng)}
    for s in (0, 1):
        eng.release_slot(s)
    for stream in STREAMS:
        out[stream] = _serve(eng, jsched, stream)
    eng.close()
    return out


@pytest.fixture(scope="module")
def port_whole(params_np):
    eng = _port_engine(params_np, **WHOLE)
    out = {"steps": _drive(eng)}
    for s in (0, 1):
        eng.release_slot(s)
    for stream in STREAMS:
        out[stream] = _serve(eng, tsched, stream)
    return out


def test_whole_prompt_step_logits_match_jax(jax_whole, port_whole):
    (jl, jt), (tl, tt) = jax_whole["steps"], port_whole["steps"]
    assert tt == jt
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_whole_prompt_serve_streams_equal_jax(stream, jax_whole, port_whole,
                                              port_results):
    (jrep, jtoks), (trep, ttoks) = jax_whole[stream], port_whole[stream]
    assert trep["completed"] == jrep["completed"] == len(ttoks)
    assert ttoks == jtoks == port_results[stream][1]
    for key in ("decode_tokens", "prefill_tokens", "iterations"):
        assert trep[key] == jrep[key], key
    assert trep["prefix"]["hit_rate"] == 0       # no sharing on this path


def test_whole_prompt_engine_refuses_batched_admission(params_np):
    eng = _port_engine(params_np, **WHOLE)
    with pytest.raises(RuntimeError, match="chunked prefill"):
        eng.prefill_many([(0, _prompt(5, 0), 4)])


def test_prefill_full_paged_with_flash_matches_jax(params_np):
    """T = 128 through flash attention on both sides; the prompt's K/V
    land in the slot's (scattered) blocks, the padding's past the table
    nowhere."""
    L, bs, nB, J = JCFG.num_layers, 8, 20, 16
    shape = (L, 1, nB, JCFG.num_heads, bs, JCFG.head_dim)
    plen = 37
    table = np.full((1, J), -1, np.int32)
    table[0, :5] = [13, 2, 19, 7, 0]
    tokens = np.zeros(128, np.int32)
    tokens[:plen] = _prompt(plen, 4)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    jl, jk, jv = jdecode.gpt2_prefill_full_paged(
        jp, jnp.zeros(shape), jnp.zeros(shape), jnp.asarray(tokens),
        jnp.asarray(table), jnp.int32(plen - 1), JCFG, attention_fn=jflash)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    tl = tdecode.gpt2_prefill_full_paged(
        convert.from_jax_params(params_np), kc, vc, torch.from_numpy(tokens),
        torch.from_numpy(table), plen - 1, TCFG, attention_fn=tflash)
    assert tl.shape == (TCFG.vocab_size,) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for t, j in ((kc, jk), (vc, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)
    assert float(kc[:, 0, 1].abs().sum()) == 0   # an unowned block
