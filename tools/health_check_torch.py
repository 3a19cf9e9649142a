#!/usr/bin/env python3
"""Health-layer self-check of the PyTorch port (``tools/health_check.py``
on ``deepspeed_tpu_torch``).

One short telemetry-enabled run with the health layer armed proves, end
to end:

1. an induced-NaN fp16 step emits an ``anomaly`` event naming the FIRST
   non-finite gradient leaf and its layer (the engine's grad-tap
   provenance);
2. the run closes with the terminal ``final`` marker and the report
   tool's ``health`` section validates (not truncated, flight recorder
   present and parseable, anomaly counted);
3. the health layer added ZERO host<->device sync fences on the hot
   path (``utils/timer.py::device_sync_count``, compared against a
   telemetry-disabled twin of the same run).

JAX's check runs a small MLP on a dp=8 CPU mesh; this one runs the same
kind of MLP (8 -> 16 -> 4, fp16 with loss scale 2^4) in a single
process: on the card unless given ``--cpu``. The NaN enters one step's
loss through a term on ``w2`` alone, so the first non-finite leaf is
``['w2']``.

    python tools/health_check_torch.py            # on the card
    python tools/health_check_torch.py --cpu

``--seed-failure`` leaves the NaN out of the induced step: the check
must then fail.

Exit 0 = pass, 1 = any claim fails.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = 10
FIRST_LEAF = "['w2']"


def loss_fn(params, batch, rng=None):
    import torch
    x, y, c = batch
    dt = params["w1"].dtype          # (the fp16 block casts the params)
    h = torch.tanh(x.to(dt) @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(y.long(), logits.shape[-1])
    return -torch.mean(torch.sum(onehot * logp, dim=-1)) + \
        torch.sum(params["w2"] * c[0].to(dt))


def init_params(device):
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    shapes = {"w1": (8, 16), "b1": (16,), "w2": (16, 4), "b2": (4,)}
    return {k: torch.from_numpy(
        (rng.standard_normal(s) * 0.1 if k[0] == "w" else np.zeros(s))
        .astype(np.float32)).to(device) for k, s in shapes.items()}


def batch(nan=False, n=16):
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32) % 4
    c = np.zeros((n, 16, 4), np.float32)
    if nan:
        c[0, 3, 1] = np.nan
    return x, y, c


def run_once(device, out_dir, telemetry: bool, nan_step: bool = True
             ) -> int:
    import deepspeed_tpu_torch.utils.timer as timer_mod
    from deepspeed_tpu_torch import initialize
    ds = {"train_batch_size": 16, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
          "fp16": {"enabled": True, "initial_scale_power": 4}}
    if telemetry:
        ds["telemetry"] = {"enabled": True, "output_path": out_dir,
                           "job_name": "health_check",
                           "report_steps": STEPS}
    eng = initialize(model=loss_fn, model_params=init_params(device),
                     config=ds, device=device, rng=0)[0]
    good = batch()
    # Warm up before counting: the first steps' one-time work is not
    # hot-path traffic.
    eng.train_batch(good)
    eng.train_batch(good)
    before = timer_mod.device_sync_count()
    for _ in range(STEPS - 3):
        eng.train_batch(good)
    eng.train_batch(batch(nan=nan_step))     # the induced-NaN step
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
                    help="leave the NaN out (the check must fail)")
    args = ap.parse_args(argv)
    import torch
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        print("health_check_torch FAIL: no CUDA device (pass --cpu)")
        return 1
    failures = []
    with tempfile.TemporaryDirectory() as tmp_off, \
            tempfile.TemporaryDirectory() as tmp_on:
        syncs_off = run_once(device, tmp_off, telemetry=False)
        syncs_on = run_once(device, tmp_on, telemetry=True,
                            nan_step=not args.seed_failure)
        if syncs_on != syncs_off:
            failures.append(
                f"fence: health-enabled run issued {syncs_on} device "
                f"syncs vs {syncs_off} disabled — hot path regressed")
        summary = load_report_tool().summarize(
            os.path.join(tmp_on, "health_check.jsonl"))
        health = summary["health"]
        if not health["available"]:
            failures.append("health section unavailable")
        if summary["truncated"] is not False:
            failures.append(
                f"truncated verdict {summary['truncated']!r} on a "
                f"cleanly closed run (final marker missing?)")
        if health["anomalies"]["nonfinite"] < 1:
            failures.append("induced-NaN step produced no non-finite "
                            "anomaly event")
        evs = health["anomalies"]["events"]
        named = [e for e in evs if e.get("first_nonfinite_leaf")]
        if not named:
            failures.append("anomaly events carry no first-non-finite-"
                            "leaf provenance")
        else:
            if named[0]["first_nonfinite_leaf"] != FIRST_LEAF:
                failures.append(
                    f"first non-finite leaf {named[0]['first_nonfinite_leaf']}"
                    f", expected {FIRST_LEAF}")
            print(f"health_check_torch: anomaly provenance -> leaf "
                  f"{named[0]['first_nonfinite_leaf']} (layer "
                  f"{named[0]['first_nonfinite_layer']})")
        fr = health["flight_recorder"]
        if not (fr.get("present") and fr.get("reason") == "close"
                and not fr.get("parse_error")):
            failures.append(f"flight recorder artifact wrong: {fr}")
        print(f"health_check_torch: device={device}, "
              f"anomalies={health['anomalies']['counts']}, "
              f"watchdog_fires={health['watchdog_fires']}, "
              f"flight={fr.get('present')}, "
              f"added_device_syncs={syncs_on - syncs_off}")
    if failures:
        for f in failures:
            print(f"health_check_torch FAIL: {f}")
        return 1
    print("health_check_torch: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
