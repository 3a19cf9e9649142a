#!/usr/bin/env python3
"""Device-trace capture self-check of the PyTorch port
(``tools/profile_check.py`` on ``deepspeed_tpu_torch``).

One short telemetry-enabled train run with a 2-step armed
``telemetry.profile`` window (a ``torch.profiler`` capture) proves, end
to end:

1. the capture is located, ingested, bucketed, and reconciled FROM THE
   TELEMETRY JSONL ALONE (``profile_window`` event -> trace dir ->
   ``profile`` report section) — no side channel;
2. the per-step wall decomposition is exact: buckets + idle +
   unattributed residual sum to the measured window wall within 5%;
3. reconciliation emits a boundedness verdict for every registered
   cost-model path;
4. profiling adds ZERO host<->device sync fences when configured off
   AND when armed but outside the window (``utils/timer.py::
   device_sync_count`` vs a telemetry-disabled twin).

JAX's check runs on a dp=8 CPU mesh; this one is a single process: on
the card (gpt2-small, bf16, gas 2 x 8 x 512) unless given ``--cpu``
(gpt2-tiny, fp32, gas 2 x 2 x 32).

    python tools/profile_check_torch.py           # on the card
    python tools/profile_check_torch.py --cpu

``--seed-failure`` deletes the capture's trace file before the drain
that ingests it: the check must then fail.

Exit 0 = pass, 1 = any claim fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = 12
WINDOW = (4, 2)      # start_step, window_steps
SUM_TOLERANCE = 0.05
GAS = 2


def recipe(device):
    """(model config, ds_config extras, micro batch, sequence length)."""
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS
    if device.type == "cuda":
        return GPT2_CONFIGS["gpt2-small"], {"bf16": {"enabled": True}}, 8, 512
    return (dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"],
                                dtype=torch.float32), {}, 2, 32)


def run_once(device, out_dir, telemetry: bool, profile=None,
             steps: int = STEPS, seed_failure: bool = False) -> int:
    """One train run; returns the hot-path device syncs (the first two
    steps excluded). ``profile``: None = no profile block; (start, n) =
    an armed window."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch.utils.timer as timer_mod
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss_fn
    cfg, extra, micro, seq = recipe(device)
    ds = dict({"train_batch_size": GAS * micro,
               "train_micro_batch_size_per_gpu": micro,
               "steps_per_print": 10 ** 9,
               "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}}},
              **extra)
    if telemetry:
        tcfg = {"enabled": True, "output_path": out_dir,
                "job_name": "profile_check", "report_steps": 5}
        if profile is not None:
            tcfg["profile"] = {"start_step": profile[0],
                               "window_steps": profile[1]}
        ds["telemetry"] = tcfg
    eng = initialize(
        model=gpt2_loss_fn(cfg),
        model_params=gpt2_init(
            cfg, torch.Generator(device=device).manual_seed(0), device),
        config=ds, device=device, rng=0)[0]
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (GAS * micro, seq + 1)))
    # Warm up before counting: the first steps' one-time work is not
    # hot-path traffic.
    eng.train_batch(batch)
    eng.train_batch(batch)
    before = timer_mod.device_sync_count()
    for _ in range(steps - 2):
        eng.train_batch(batch)
        win = eng.telemetry.profiler
        if seed_failure and win is not None and not win._active and \
                os.path.exists(win.trace_file):
            os.remove(win.trace_file)
    synced = timer_mod.device_sync_count() - before
    eng.close()
    return synced


def load_report_tool():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(REPO, "tools",
                                         "telemetry_report.py"))
    rep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rep)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--seed-failure", action="store_true",
                    help="delete the capture before its drain (the check "
                         "must fail)")
    args = ap.parse_args(argv)
    import torch
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        print("profile_check_torch FAIL: no CUDA device (pass --cpu)")
        return 1
    failures = []
    with tempfile.TemporaryDirectory() as t_off, \
            tempfile.TemporaryDirectory() as t_noprof, \
            tempfile.TemporaryDirectory() as t_armed_out, \
            tempfile.TemporaryDirectory() as t_prof:
        # Fence twins: telemetry off / profile off / armed-but-outside.
        syncs_off = run_once(device, t_off, telemetry=False)
        syncs_noprof = run_once(device, t_noprof, telemetry=True)
        syncs_armed_out = run_once(device, t_armed_out, telemetry=True,
                                   profile=(10 ** 6, 2))
        if syncs_noprof != syncs_off:
            failures.append(
                f"fence: profiling-off telemetry run issued "
                f"{syncs_noprof} device syncs vs {syncs_off} disabled")
        if syncs_armed_out != syncs_off:
            failures.append(
                f"fence: armed-outside-window run issued "
                f"{syncs_armed_out} device syncs vs {syncs_off} disabled")

        # The profiled run: window over 2 post-warmup hot steps.
        run_once(device, t_prof, telemetry=True, profile=WINDOW,
                 seed_failure=args.seed_failure)
        summary = load_report_tool().summarize(
            os.path.join(t_prof, "profile_check.jsonl"))

        if summary["truncated"] is not False:
            failures.append(
                f"truncated verdict {summary['truncated']!r} on a "
                f"cleanly closed run")
        prof = summary["profile"]
        recon, sc = None, {}
        if not prof.get("available"):
            failures.append("profile section unavailable — capture not "
                            "ingested from the JSONL")
        else:
            wins = prof.get("windows") or []
            ok_stop = [w for w in wins
                       if w.get("phase") == "stop" and w.get("ok")]
            if not ok_stop:
                failures.append(f"no successful profile_window stop "
                                f"event (windows: {wins})")
            if prof.get("error"):
                failures.append(f"ingest error: {prof['error']}")
            sc = prof.get("sum_check") or {}
            frac = sc.get("explained_frac")
            if frac is None or abs(frac - 1.0) > SUM_TOLERANCE:
                failures.append(
                    f"decomposition does not sum to the step wall "
                    f"within {SUM_TOLERANCE:.0%}: explained_frac={frac} "
                    f"(sum_check={sc})")
            if not prof.get("n_device_ops"):
                failures.append("ingest found zero device ops")
            recon = prof.get("reconciliation")
            if not recon:
                failures.append("no reconciliation section (cost model "
                                "missing at ingest time?)")
            else:
                if recon.get("verdict") not in ("match", "mismatch"):
                    failures.append(
                        f"boundedness verdict {recon.get('verdict')!r} "
                        f"is not decisive")
                registered = set(summary["roofline"].get("paths") or {})
                verdicts = recon.get("paths") or {}
                missing = registered - set(verdicts)
                if missing or not registered:
                    failures.append(
                        f"registered paths without a boundedness "
                        f"verdict: {sorted(missing)} (registered: "
                        f"{sorted(registered)})")
                bad = [k for k, v in verdicts.items()
                       if v.get("verdict") not in
                       ("match", "mismatch", "indeterminate",
                        "unavailable")]
                if bad:
                    failures.append(f"malformed path verdicts: {bad}")
        if not failures:
            print(f"profile_check_torch: device={device}, per-step "
                  f"wall={prof['per_step_wall_ms']}ms, buckets="
                  f"{prof['per_step_ms']}, families="
                  f"{prof['pallas_families_ms']}, explained="
                  f"{sc.get('explained_frac'):.1%}, verdict="
                  f"{recon['verdict']} (dominant="
                  f"{recon['dominant_bucket']}, predicted="
                  f"{recon['predicted_bound']}), "
                  f"paths={list((recon.get('paths') or {}))}, "
                  f"added_syncs off/outside="
                  f"{syncs_noprof - syncs_off}/"
                  f"{syncs_armed_out - syncs_off}")
    if failures:
        for f in failures:
            print(f"profile_check_torch FAIL: {f}")
        return 1
    print("profile_check_torch: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
