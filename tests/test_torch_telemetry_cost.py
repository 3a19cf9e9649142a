"""The port's flops profiler (``profiling/flops_profiler``), its kernels'
declared costs (``ops/costs.py``) and the roofline cost model
(``monitor/cost_model.py``, ``monitor/peaks.py``) against the JAX
package's, on the CPU.

- Flops: the matmul count is exact; gpt2-tiny's forward MACs equal JAX
  ``profile_fn``'s and the analytic formula, and ``gpt2_apply`` holds at
  least 99% of the flops; a kernel wrapper's call counts its declared
  cost and hides its plain version's aten ops; the engine profiles the
  step at ``flops_profiler.profile_step`` and prints the table.
- Costs: each kernel's ``(flops, bytes)`` at the shapes ``chip_smoke.py``
  bounds it with equals the formula the smoke's bound had inline;
  ``layout_pairs`` equals the element mask's count.
- Cost model: the roofline verdicts; ``mfu`` bit-equal to JAX's formula
  on the same inputs; the step fusion's weights and missing paths; the
  engine's walked train step has exactly the MACs of JAX's jaxpr walk
  of its train step (so its matmul flops are equal), and its total
  flops within 1% of JAX's analytic count (the elementwise ops
  decompose differently: torch's softmax is one op, JAX's five
  primitives); the trio's paths priced with the gas weighting; the
  card's peak row and the assumed fallback.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.monitor import cost_model as jcm
from deepspeed_tpu.monitor import peaks as jpeaks
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.profiling.flops_profiler import profile_fn as jprofile
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.monitor import cost_model as tcm
from deepspeed_tpu_torch.monitor import peaks as tpeaks
from deepspeed_tpu_torch.ops import costs
from deepspeed_tpu_torch.ops import fused_elementwise as fe
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.profiling.flops_profiler import (
    get_model_profile, profile_fn)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------- #
# Flops profiler (tests/test_flops_profiler.py, case for case)
# --------------------------------------------------------------------- #
def test_matmul_exact_count():
    a, b = torch.ones(8, 32), torch.ones(32, 16)
    res = profile_fn(lambda x, y: x @ y, a, b, run=False)
    assert res.total_macs == 8 * 32 * 16
    assert res.total_flops == 2 * 8 * 32 * 16
    assert res.total_bytes == (8 * 32 + 32 * 16 + 8 * 16) * 4


def test_loop_multiplies_body():
    """(JAX's scan case: the walk sees each trip of a Python loop.)"""
    def fn(x):
        for _ in range(5):
            x = torch.tanh(x @ x)
        return x

    res = profile_fn(fn, torch.ones(16, 16), run=False)
    assert res.total_macs == 5 * 16 * 16 * 16


def test_gpt2_tiny_counts_match_jax_and_the_formula():
    tcfg = tgpt2.GPT2_CONFIGS["gpt2-tiny"]
    jcfg = jgpt2.GPT2_CONFIGS["gpt2-tiny"]
    jparams = jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg)
    params = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jparams))
    B, S = 2, tcfg.max_seq_length
    res = profile_fn(lambda p, t: tgpt2.gpt2_apply(p, t, tcfg), params,
                     torch.zeros(B, S, dtype=torch.long), run=False)
    jres = jprofile(lambda p, t: jgpt2.gpt2_apply(p, t, jcfg), jparams,
                    jnp.zeros((B, S), jnp.int32), run=False)
    n_tok = B * S
    H, L = tcfg.hidden_size, tcfg.num_layers
    F, V = tcfg.ffn_size, tcfg.vocab_size
    per_block = 3 * H * H + H * H + 2 * H * F
    expected = n_tok * (L * per_block + L * 2 * S * H + H * V)
    assert res.total_macs == jres.total_macs == expected
    assert res.total_params == jres.total_params
    top = dict((p, f) for p, f, _ in res.aggregate_by_depth(0))
    assert top["gpt2_apply"] >= 0.99 * res.total_flops
    # The module tree reaches the blocks as JAX's does.
    paths = [p for p, _, _ in res.aggregate_by_depth(-1)]
    assert any(p.startswith("gpt2_apply/gpt2_hidden/apply_blocks")
               for p in paths)


def test_top_modules_and_format():
    def mm(x):
        return x @ x

    res = profile_fn(mm, torch.ones(8, 8), run=False)
    text = res.format_profile()
    assert "Flops Profiler" in text and "FLOPs" in text
    assert res.top_modules(1)


def test_get_model_profile_strings():
    flops, macs, params = get_model_profile(
        lambda x: x @ x, (torch.ones(4, 4),), print_profile=False,
        as_string=True)
    assert flops.endswith("FLOPs") and macs.endswith("MACs")


def test_kernel_call_counts_its_declared_cost():
    x = torch.randn(64, 48)
    d = torch.randn(64, 48)
    sc, bi = torch.ones(48), torch.zeros(48)
    res = profile_fn(lambda: fe.fused_residual_layer_norm(x, d, sc, bi),
                     run=False)
    want = costs.layer_norm_fwd(64, 48, 4, residual=True)
    assert (res.total_flops, res.total_bytes) == (want.flops, want.bytes)
    assert res.kernels == {"K3f": [1, float(want.flops),
                                   float(want.bytes)]}


def test_engine_profiles_the_configured_step(capsys):
    cfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=torch.float32)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(cfg),
        model_params=tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                                     "cpu"),
        config={"train_batch_size": 2, "steps_per_print": 10 ** 9,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "flops_profiler": {"enabled": True, "profile_step": 1}},
        device="cpu")
    batch = np.random.default_rng(0).integers(0, 512, (2, 33))
    eng.train_batch(batch)
    assert eng.flops_profiler.result is None
    eng.train_batch(batch)
    res = eng.flops_profiler.result
    assert res is not None and res.total_flops > 0 and \
        res.total_params == tgpt2.gpt2_num_params(cfg)
    assert "Flops Profiler" in capsys.readouterr().out
    # The profiled step is a step: the engine counts it.
    assert eng.global_steps == 2


# --------------------------------------------------------------------- #
# Declared costs at chip_smoke.py's bound shapes
# --------------------------------------------------------------------- #
def test_costs_equal_the_smoke_bound_formulas():
    """Each formula as chip_smoke.py priced its bound before it read
    ops/costs.py (bf16 at H 768, F 3072, the training rows; the flash
    kernels at B x 12 heads x S x 64)."""
    H, Fw, rows = 768, 3072, 8192
    for resid in (False, True):
        assert costs.layer_norm_fwd(rows, H, 2, resid) == (
            8 * rows * H, (4 if resid else 2) * rows * H * 2 + 2 * H * 4, 0)
        assert costs.layer_norm_bwd(rows, H, 2, resid) == (
            12 * rows * H, (4 if resid else 3) * rows * H * 2 + 3 * H * 4,
            0)
    assert costs.bias_gelu_fwd(rows, Fw, 2)[:2] == (
        12 * rows * Fw, 2 * rows * Fw * 2 + Fw * 4)
    assert costs.bias_gelu_bwd(rows, Fw, 2)[:2] == (
        20 * rows * Fw, 3 * rows * Fw * 2 + 2 * Fw * 4)
    n = 124439808
    assert costs.sqnorm_cost(n)[:2] == (2 * n, 4 * n + 4)
    for p_b, c_b in ((4, 2), (4, 0), (2, 0)):
        assert costs.fused_adam_cost(n, p_b, c_b)[:2] == (
            20 * n, n * (4 + p_b + 8 + p_b + 8 + c_b))
    for B, S in ((8, 1024), (8, 768), (2, 4096)):
        N, BH, D = B * 12 * S * 64, B * 12, 64
        pairs = BH * S * (S + 1) // 2
        assert costs.causal_pairs(B, 12, S) == pairs
        assert costs.flash_fwd_cost(B, S, 12, D, pairs)[:2] == (
            4 * D * pairs, 4 * N * 2 + BH * S * 4)
        lse_delta = 2 * BH * S * 4
        assert costs.flash_bwd_fused_cost(B, S, 12, D, pairs)[:2] == (
            10 * D * pairs, 7 * N * 2 + lse_delta)
        assert costs.flash_bwd_dq_cost(B, S, 12, D, pairs)[:2] == (
            6 * D * pairs, 5 * N * 2 + lse_delta)
        assert costs.flash_bwd_dkv_cost(B, S, 12, D, pairs)[:2] == (
            8 * D * pairs, 6 * N * 2 + lse_delta)
    E, M, K, N2 = 8, 1024, 768, 3072
    assert costs.grouped_gemm_cost(E, M, K, N2, 2, True)[:2] == (
        2.0 * E * M * K * N2,
        (E * M * K + E * K * N2 + E * M * N2) * 2 + E * N2 * 4)


@pytest.mark.parametrize("causal", [True, False])
def test_layout_pairs_count_the_element_mask(causal):
    rng = np.random.default_rng(3)
    layout = (rng.random((4, 8, 8)) < 0.4).astype(np.int64)
    S = 8 * 16
    mask = fa.layout_element_mask(layout, S, causal, torch.device("cpu"))
    assert costs.layout_pairs(layout, S, causal, B=3) == \
        3 * int(mask.sum())


# --------------------------------------------------------------------- #
# Roofline and MFU (tests/test_cost_model.py's cases)
# --------------------------------------------------------------------- #
def _both_peaks():
    """JAX's v5e row and the same numbers as a port ChipPeaks."""
    j = jpeaks.peaks_for_kind("TPU v5 lite")
    t = tpeaks.ChipPeaks(name=j.name, bf16_tflops=j.bf16_tflops,
                         hbm_gbs=j.hbm_gbs, ici_gbs=j.ici_gbs,
                         dcn_gbs=j.dcn_gbs)
    return j, t


@pytest.mark.parametrize("flops, nbytes, comm", [
    (1e15, 1e6, 0.0), (1e9, 1e12, 0.0), (1e9, 1e6, 1e12),
    (3.3e12, 7.7e9, 1.1e9)])
def test_roofline_matches_jax(flops, nbytes, comm):
    jp, tp = _both_peaks()
    assert tcm.roofline(flops, nbytes, comm, tp) == \
        jcm.roofline(flops, nbytes, comm, jp)


@pytest.mark.parametrize("flops, t, n", [
    (2.5e12, 0.31, 1), (7.7e15, 1.7, 4), (1.0, 1e-9, 8), (5e9, 0.0, 1),
    (5e9, 1.0, 0)])
def test_mfu_is_bit_equal_to_jax(flops, t, n):
    jp, tp = _both_peaks()
    assert tcm.mfu(flops, t, n, tp) == jcm.mfu(flops, t, n, jp)


def test_peaks_table():
    p = tpeaks.peaks_for_kind("NVIDIA H100 80GB HBM3")
    assert (p.name, p.bf16_tflops, p.hbm_gbs, p.assumed) == \
        ("h100-sxm", 989.0, 3350.0, False)
    assert p.flops_per_sec == 989e12 and p.hbm_bytes_per_sec == 3.35e12
    q = tpeaks.peaks_for_kind("cpu")
    assert q.assumed and q.bf16_tflops == p.bf16_tflops
    assert tpeaks.chip_peaks("cpu").assumed


class _Reg:
    def __init__(self, walks):
        self._w = walks

    def registered_paths(self):
        return self._w


def test_step_fusion_weights_and_missing():
    w = profile_fn(lambda x: x @ x, torch.ones(64, 64), run=False)
    _, tp = _both_peaks()
    cm = tcm.build_cost_model(_Reg({"grad_step": w, "apply_grads": w}),
                              {}, {"grad_step": 4.0, "apply_grads": 1.0,
                                   "gone": 1.0}, 1, peaks=tp)
    assert cm["step"]["flops_per_step"] == 5 * w.total_flops
    assert cm["step"]["missing_paths"] == ["gone"]
    assert cm["paths"]["grad_step"]["bytes_source"] == "op_walk"
    floor = 5 * cm["paths"]["grad_step"]["floor_ms"]
    assert cm["step"]["floor_ms"] == round(floor, 6)


# --------------------------------------------------------------------- #
# The engine's cost model against JAX's
# --------------------------------------------------------------------- #
def _ds(**extra):
    ds = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "bf16": {"enabled": True},
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    ds.update(extra)
    return ds


def test_walked_train_step_matches_jax_analytic_count(tmp_path):
    off = dict(hidden_dropout=0.0, attn_dropout=0.0)
    tcfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], **off)
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               fused_kernels=False, dtype=jnp.bfloat16,
                               **off)
    params = jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg))
    tel = {"enabled": True, "output_path": str(tmp_path),
           "report_steps": 1}
    jeng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        config=_ds(telemetry=dict(tel, job_name="jax")),
        mesh=build_mesh(devices=jax.devices()[:1]))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params),
        config=_ds(telemetry=dict(tel, job_name="port")), device="cpu")
    batch = np.random.default_rng(0).integers(0, 512, (4, 33))
    jeng.train_batch(batch.astype(np.int32))
    teng.train_batch(batch)
    fn, a, k = jeng.telemetry.sentinel.registered_paths()["train_step"]
    jres = jprofile(fn, *a, **k, run=False)
    jpath = jeng.telemetry.cost_model_payload["paths"]["train_step"]
    tpath = teng.telemetry.cost_model_payload["paths"]["train_step"]
    assert tpath["analytic_macs"] == jres.total_macs
    # (the matmul flops are 2 x MACs on both sides; the elementwise ops
    # decompose differently: within 1%)
    assert jpath["analytic_flops"] == jres.total_flops
    assert abs(tpath["analytic_flops"] / jpath["analytic_flops"] - 1) \
        <= 0.01
    jeng.telemetry.close()
    teng.close()


def test_trio_paths_priced_with_gas_weighting(tmp_path):
    """The trio's paths (a forward and a backward a micro-batch, one
    apply) are weighted by gas, and a window of them has the MACs of the
    fused train step on the same rows."""
    cfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=torch.float32)

    def engine(job):
        return deepspeed_tpu_torch.initialize(
            model=tgpt2.gpt2_loss_fn(cfg),
            model_params=tgpt2.gpt2_init(
                cfg, torch.Generator().manual_seed(0), "cpu"),
            config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                    "steps_per_print": 10 ** 9,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                    "telemetry": {"enabled": True, "job_name": job,
                                  "output_path": str(tmp_path),
                                  "report_steps": 1}},
            device="cpu")[0]

    trio, fused = engine("trio"), engine("fused")
    rows = np.random.default_rng(0).integers(0, 512, (2, 33))
    for _ in range(2):
        loss = trio.forward(rows)
        trio.backward(loss)
        trio.step()
    fused.train_batch(np.concatenate([rows, rows]))
    cm = trio.telemetry.cost_model_payload
    assert cm["step"]["paths"] == {"grad_step": 2.0, "grad_step_bwd": 2.0,
                                   "apply_grads": 1.0}
    assert cm["step"]["missing_paths"] == []
    p = cm["paths"]
    assert cm["step"]["flops_per_step"] == \
        2 * p["grad_step"]["analytic_flops"] + \
        2 * p["grad_step_bwd"]["analytic_flops"] + \
        p["apply_grads"]["analytic_flops"]
    fp = fused.telemetry.cost_model_payload["paths"]["train_step"]
    assert 2 * (p["grad_step"]["analytic_macs"] +
                p["grad_step_bwd"]["analytic_macs"]) == fp["analytic_macs"]
    trio.close()
    fused.close()
