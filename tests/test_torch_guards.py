"""Guards on the PyTorch port's boundaries: it imports no JAX and nothing
of the JAX package, its entry points refuse to run without CUDA unless a
device is given, building its kernels raises without nvcc, the ctypes
signatures match the kernels' C entry points, the flash kernels and
the grouped GEMM use neither ``nvcuda::wmma`` nor atomics (the grouped
GEMM runs on TMA and ``wgmma``), the engine refuses configurations
it has no CUDA path for, and the ``inference`` config parses and rejects
exactly as the JAX package's does; the serving engine serves with
telemetry (or its tensorboard alias) on, and both engines refuse a
profiler window."""
import ast
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_init
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.runtime import config as tconfig

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "deepspeed_tpu", "transformers")
CFG32 = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)


def test_import_pulls_in_no_jax():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.inference, "
            "deepspeed_tpu_torch.models.convert, deepspeed_tpu_torch.moe, "
            "deepspeed_tpu_torch.runtime.zero.stage3, "
            "deepspeed_tpu_torch.monitor, deepspeed_tpu_torch.ops.costs, "
            "deepspeed_tpu_torch.profiling.flops_profiler, "
            "deepspeed_tpu_torch.parallel.wire_model, "
            "deepspeed_tpu_torch.models.bert, "
            "deepspeed_tpu_torch.module_inject, "
            "deepspeed_tpu_torch.monitor.request_trace, "
            "deepspeed_tpu_torch.monitor.profile_ingest, "
            "deepspeed_tpu_torch.monitor.reconcile, "
            "deepspeed_tpu_torch.ops.sparse_attention."
            "sparse_attention_utils, deepspeed_tpu_torch.ops.autotune, "
            "deepspeed_tpu_torch.launcher.launch, "
            "deepspeed_tpu_torch.launcher.multinode_runner, "
            "deepspeed_tpu_torch.env_report\n"
            "sys.path.insert(0, 'tests'); import torch_dp_worker\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_module_imports_jax():
    """No module of the package, not chip_smoke.py, not the dp tests'
    worker, and not the port's example trainers, crash-kill harness,
    self-checks (``tools/*_check_torch.py``) or ``bin/*_torch`` entry
    points imports JAX, the JAX package or
    ``transformers`` (the card's machine has none: ``module_inject``
    takes configs by attribute and weights as tensors)."""
    offenders = []
    front_door = [*REPO.glob("examples/*/train_torch.py"),
                  REPO / "examples" / "torch_example_common.py",
                  REPO / "tools" / "crashkill_torch.py",
                  *REPO.glob("tools/*_check_torch.py"),
                  *REPO.glob("bin/*_torch")]
    assert len(front_door) == 12, front_door
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py",
                 REPO / "tests" / "torch_dp_worker.py", *front_door]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert not offenders


def test_engine_without_device_raises_without_cuda(monkeypatch):
    params = gpt2_init(CFG32, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(CFG32, params, config={})


def test_op_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(op_builder, "DEFAULT_CUDA_HOME", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        op_builder.build()


def test_op_builder_sources_cover_the_kernels():
    names = {p.name for p in op_builder.sources()}
    assert {"flash_attention.cu", "fused_elementwise.cu", "fused_update.cu",
            "grouped_gemm.cu", "paged_attention.cu",
            "sparse_flash.cu"} <= names


def _c_entry_points():
    """{name: number of parameters} of every ``extern "C"`` function in
    csrc/ (the kernels compile only on the card, so a ctypes signature
    that drifts from its C definition shows nowhere else)."""
    out = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        for m in re.finditer(r'extern "C"[^(]*?\b(dstt_\w+)\(([^)]*)\)',
                             src.read_text()):
            out[m.group(1)] = len([a for a in m.group(2).split(",")
                                   if a.strip()])
    return out


@pytest.mark.parametrize("name", sorted(op_builder._SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    entries = _c_entry_points()
    assert name in entries
    assert len(op_builder._SIGNATURES[name][0]) == entries[name]


def test_flash_kernels_use_mma_sync_and_no_wmma_or_atomics():
    """The flash and sparse tiles run on mma.sync from ldmatrix fragments
    (csrc/mma.cuh); no nvcuda::wmma, and no atomics, so two launches give
    the same bits."""
    csrc = PKG / "csrc"
    for name in ("flash_tiles.cuh", "flash_attention.cu", "sparse_flash.cu"):
        text = (csrc / name).read_text()
        assert "nvcuda" not in text and "<mma.h>" not in text, name
        assert not re.search(r"\batomic\w*\(", text), name
    tiles = (csrc / "flash_tiles.cuh").read_text()
    for struct in ("FwdTiles", "DqTiles", "DkvTiles"):
        body = tiles.split(f"struct {struct} {{", 1)[1].split("\n};", 1)[0]
        assert "tc::ldsm_x4" in body and "tc::mma16816" in body, struct


def test_grouped_gemm_kernel_uses_tma_and_wgmma_and_no_wmma_or_atomics():
    """K9's bf16/fp16 kernel loads through TMA into an mbarrier ring and
    multiplies with wgmma.mma_async (the PTX wrappers of csrc/wgmma.cuh);
    no nvcuda::wmma and no atomics, so two launches give the same bits."""
    csrc = PKG / "csrc"
    gg = (csrc / "grouped_gemm.cu").read_text()
    hop = (csrc / "wgmma.cuh").read_text()
    for text in (gg, hop):
        assert "nvcuda" not in text and "<mma.h>" not in text
        assert not re.search(r"\batomic\w*\(", text)
    assert '#include "wgmma.cuh"' in gg
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor",
                "mbarrier.try_wait", "setmaxnreg"):
        assert ptx in hop, ptx
    kernel = gg.split("grouped_gemm_wgmma_kernel(", 1)[1].split("\n}\n", 1)[0]
    for call in ("hop::tma_load_3d", "hop::mbar_wait", "hop::mbar_arrive",
                 "hop::mma_async", "hop::wgmma_wait", "hop::regs_dec"):
        assert call in kernel, call


@pytest.mark.parametrize("config", [
    {"telemetry": {"enabled": True}},
    {"tensorboard": {"enabled": True}},      # telemetry's alias
])
def test_engine_refuses_unported_layouts(config, tmp_path):
    """The serving engine refused telemetry and its tensorboard alias
    before slice 6i (as it refused the slot-major layout and weight
    quantization before slice 6g); both now build and serve with a
    stream: request traces, the report's ``trace`` key, a ``final``
    record at close. An explicit ``enabled: false`` writes nothing."""
    import json

    from deepspeed_tpu_torch.inference.scheduler import synthetic_requests
    params = gpt2_init(CFG32, torch.Generator().manual_seed(0), "cpu")
    block = next(iter(config))
    config = {block: dict(config[block], output_path=str(tmp_path / "on"))}
    eng = InferenceEngine(CFG32, params, config=config, device="cpu")
    rep = eng.serve(synthetic_requests(3, prompt_len=(4, 8),
                                       max_new_tokens=3, vocab_size=512))
    eng.close()
    assert rep["completed"] == 3 and rep["trace"]["completed"] == 3
    streams = list((tmp_path / "on").glob("*.jsonl"))
    assert len(streams) == 1
    recs = [json.loads(line) for line in streams[0].read_text().split("\n")
            if line]
    assert recs[0]["kind"] == "meta" and recs[0]["mode"] == "serving"
    assert recs[-1]["kind"] == "final"
    assert sum(r.get("event") == "request_trace" for r in recs) == 3
    explicit_off = {"telemetry": {"enabled": False,
                                  "output_path": str(tmp_path / "off")}}
    eng = InferenceEngine(CFG32, params, config=explicit_off, device="cpu")
    assert "trace" not in eng.serve(synthetic_requests(
        2, prompt_len=(4, 8), max_new_tokens=2, vocab_size=512))
    eng.close()
    assert not (tmp_path / "off").exists()


def test_unported_features_leave_out_telemetry_and_the_flops_profiler():
    """Training telemetry (its tensorboard alias too) and the flops
    profiler build an engine: neither is an unported feature."""
    for extra in ({"telemetry": {"enabled": True}},
                  {"tensorboard": {"enabled": True}},
                  {"flops_profiler": {"enabled": True}}):
        c = tconfig.DeepSpeedConfig(dict({"train_batch_size": 2}, **extra),
                                    world_size=1)
        assert c.unported_features() == [], extra


def test_profile_window_raises_naming_item_9(tmp_path):
    """A telemetry.profile window (from the config, its flat alias, or
    ``engine.profile_window``) arms a ``torch.profiler`` capture under
    ``<output_path>/torch_trace/step_<start>_<stop>`` (it raised, naming
    ROADMAP queue 1 item 9, until the window was ported). Telemetry off,
    ``profile_window`` is None, as in JAX."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn

    def engine(tel):
        return initialize(
            model=gpt2_loss_fn(CFG32),
            model_params=gpt2_init(CFG32, torch.Generator().manual_seed(0),
                                   "cpu"),
            config={"train_batch_size": 2,
                    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                    "telemetry": dict({"output_path": str(tmp_path)},
                                      **tel)},
            device="cpu")[0]

    trace_dir = tmp_path / "torch_trace"
    for block, rng in (({"profile": {"start_step": 0}}, "step_0_2"),
                       ({"profile_start_step": 2}, "step_2_3")):
        eng = engine(dict({"enabled": True}, **block))
        assert eng.telemetry.profiler.capture_dir == str(trace_dir / rng)
        assert eng.telemetry.profiler.device == torch.device("cpu")
        eng.close()
    eng = engine({"enabled": True})
    assert eng.profile_window(2) == str(trace_dir / "step_1_3")
    # An armed window is not replaced (None), as in JAX.
    assert eng.profile_window(2) is None
    eng.close()
    assert engine({"enabled": False}).profile_window(2) is None


def test_engine_builds_whole_prompt_prefill():
    params = gpt2_init(CFG32, torch.Generator().manual_seed(0), "cpu")
    eng = InferenceEngine(CFG32, params, config={"inference": {
        "prefill_chunk": 0, "max_seq_len": 128}}, device="cpu")
    assert eng.prefill_chunk == 0 and eng.max_len == 128


def test_flash_layout_mode_routes_and_runs():
    """The block-sparse layout mode runs: an all-ones 128-block layout
    takes the LUT path and equals causal flash attention."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention
    q = torch.randn(1, 256, 2, 32, generator=torch.Generator().manual_seed(0))
    got = flash_attention(q, q, q, causal=True,
                          layout=torch.ones(2, 2, 2, dtype=torch.int32))
    torch.testing.assert_close(got, flash_attention(q, q, q, causal=True),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inference, fused", [
    ({"paged_kernel": False}, "auto"),
    ({}, False),
])
def test_engine_refuses_unfused_cuda(inference, fused):
    # Checked before anything touches the device, so it runs anywhere.
    cfg = dataclasses.replace(CFG32, fused_kernels=fused)
    with pytest.raises(NotImplementedError, match="no CUDA path"):
        InferenceEngine(cfg, {}, config={"inference": inference},
                        device="cuda")


CONFIGS = [
    {},
    {"inference": {"max_slots": 8, "max_seq_len": 1024, "block_size": 16,
                   "prefill_chunk": 32, "spec_k": 3, "spec_ngram": 2,
                   "kv_cache_dtype": "bf16", "replica": "r0",
                   "slo": {"ttft_ms": 200, "tpot_ms": 20}}},
    {"inference": {"max_slots": 0}},
    {"inference": {"max_seq_len": -1}},
    {"inference": {"quantize": "fp4"}},
    {"inference": {"prefill_chunk": 1.5}},
    {"inference": {"block_size": -16}},
    {"inference": {"num_blocks": -1}},
    {"inference": {"spec_k": 2, "block_size": 0}},
    {"inference": {"spec_ngram": 0}},
    {"inference": {"kv_cache_dtype": "fp8"}},
    {"inference": {"replica": 3}},
    {"inference": {"paged_kernel": "yes"}},
    {"inference": {"slo": []}},
    {"inference": {"slo": {"availability": 1.0}}},
    {"inference": {"slo": {"window_s": 0}}},
    {"inference": {"slo": {"ttft_ms": -1}}},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_inference_config_parity(i):
    def parse(mod):
        try:
            c = mod.InferenceConfig(CONFIGS[i])
        except mod.DeepSpeedConfigError as e:
            return ("error", str(e))
        d = dict(vars(c))
        d["slo"] = dict(vars(d["slo"]))
        return ("ok", d)
    assert parse(tconfig) == parse(jconfig)
