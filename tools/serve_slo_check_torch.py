#!/usr/bin/env python3
"""Serving-observability self-check of the PyTorch port
(``tools/serve_slo_check.py`` on ``deepspeed_tpu_torch``).

One reduced shared-prefix saturation stream through two router replicas
proves, end to end:

1. request tracing adds ZERO host<->device sync fences on the serving
   hot path (``utils/timer.py::device_sync_count``, compared against a
   telemetry-disabled twin of the same stream — the trace is host
   bookkeeping by construction, and this check keeps it that way);
2. every completed request's span timeline re-validates from the JSONL
   alone: contiguous queued->prefill->decode spans (no gaps/overlaps at
   host-clock resolution), queue_wait + service_ttft == ttft;
3. each replica's serving goodput ledger is consistent (buckets sum to
   the serve wall with no double-attribution) and the report tool's
   ``serving_slo`` section parses with an SLO verdict present;
4. ``fail_on_recompile`` stays armed throughout — a post-warmup
   recompile kills the run rather than polluting the numbers.

JAX's check runs on a dp=8 CPU mesh; this one is a single process with
both replicas on one device: the card (gpt2-small, bf16) unless given
``--cpu`` (gpt2-tiny, fp32).

    python tools/serve_slo_check_torch.py         # on the card
    python tools/serve_slo_check_torch.py --cpu

``--seed-failure`` opens a 1-ms gap between two spans of one completed
request's timeline in the JSONL before it is re-validated: the check
must then fail.

Exit 0 = pass, 1 = any claim fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_REQUESTS = 10
MAX_NEW = 8


def model_config(device):
    import torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS
    if device.type == "cuda":
        return GPT2_CONFIGS["gpt2-small"]
    return dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"],
                               dtype=torch.float32)


def run_once(device, out_dir, telemetry: bool):
    """Serve the same shared-prefix stream on a 2-replica router; fence
    the measured (post-warmup) portion with device_sync_count."""
    import torch

    import deepspeed_tpu_torch.utils.timer as timer_mod
    from deepspeed_tpu_torch.inference import InferenceEngine, ReplicaRouter
    from deepspeed_tpu_torch.inference.scheduler import (
        shared_prefix_requests, synthetic_requests)
    from deepspeed_tpu_torch.models.gpt2 import gpt2_init

    cfg = model_config(device)
    params = gpt2_init(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
    engines = []
    for i in range(2):
        c = {"inference": {"max_slots": 8, "max_seq_len": 96,
                           "prefill_chunk": 8, "block_size": 16,
                           "spec_k": 4, "replica": f"r{i}",
                           # Loose targets: the check exercises the
                           # tracker, not the latency.
                           "slo": {"ttft_ms": 60000.0,
                                   "tpot_ms": 60000.0}}}
        if telemetry:
            c["telemetry"] = {"enabled": True, "output_path": out_dir,
                              "job_name": f"serve_slo_r{i}",
                              "report_steps": 8,
                              "fail_on_recompile": True}
        engines.append(InferenceEngine(cfg, params, config=c,
                                       device=device))
    # Warm every device path before fencing: first calls are not
    # hot-path traffic.
    warm = synthetic_requests(4, prompt_len=(4, 8), max_new_tokens=4,
                              vocab_size=cfg.vocab_size, seed=991)
    for r in warm:
        r.rid += 1000   # keep warmup traces apart from the measured ones
    ReplicaRouter(engines).serve(warm)
    for e in engines:
        e.reset_serving_stats()
    reqs = shared_prefix_requests(
        N_REQUESTS, prefix_len=24, tail_len=(4, 8),
        max_new_tokens=MAX_NEW, vocab_size=cfg.vocab_size, seed=0)
    router = ReplicaRouter(engines)
    before = timer_mod.device_sync_count()
    report = router.serve(reqs)
    synced = timer_mod.device_sync_count() - before
    for e in engines:
        e.close()
    return synced, report


def _trace_events(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("kind") == "event" and \
                    rec.get("event") == "request_trace":
                out.append(rec)
    return out


def open_a_gap(path):
    """Shift the second span of the first completed measured request's
    timeline by 1 ms in the JSONL (the seeded failure)."""
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        rec = json.loads(line)
        if rec.get("event") == "request_trace" and \
                rec.get("outcome") == "complete" and \
                int(rec.get("rid", -1)) < 1000:
            rec["spans"][1]["t_ms"] += 1.0
            lines[i] = json.dumps(rec) + "\n"
            break
    with open(path, "w") as f:
        f.writelines(lines)


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
                    help="open a gap in one timeline (the check must "
                         "fail)")
    args = ap.parse_args(argv)
    import torch

    from deepspeed_tpu_torch.monitor import validate_timeline
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        print("serve_slo_check_torch FAIL: no CUDA device (pass --cpu)")
        return 1
    failures = []
    with tempfile.TemporaryDirectory() as tmp_off, \
            tempfile.TemporaryDirectory() as tmp_on:
        syncs_off, _ = run_once(device, tmp_off, telemetry=False)
        syncs_on, rep_on = run_once(device, tmp_on, telemetry=True)
        if args.seed_failure:
            open_a_gap(os.path.join(tmp_on, "serve_slo_r0.jsonl"))
        if syncs_on != syncs_off:
            failures.append(
                f"fence: trace-enabled run issued {syncs_on} device "
                f"syncs vs {syncs_off} disabled — hot path regressed")
        if rep_on["unfinished"] or rep_on["recompiles"]:
            failures.append(
                f"serve: unfinished={rep_on['unfinished']}, "
                f"recompiles={rep_on['recompiles']}")
        if rep_on.get("completed") != N_REQUESTS:
            failures.append(
                f"serve: {rep_on.get('completed')} of {N_REQUESTS} "
                f"requests completed")
        # Per-replica ledgers from the live report: consistent buckets.
        for snap in rep_on.get("replicas") or []:
            led = snap.get("ledger")
            if not isinstance(led, dict):
                failures.append(
                    f"replica {snap.get('replica')}: no ledger section")
            elif not led.get("consistent"):
                failures.append(
                    f"replica {snap.get('replica')}: ledger "
                    f"double-attribution (accounted="
                    f"{led.get('accounted_fraction')})")
        # Every completed request's timeline re-validates from the
        # JSONL alone (both replicas' streams together hold them all).
        traces = []
        for i in range(2):
            traces.extend(_trace_events(
                os.path.join(tmp_on, f"serve_slo_r{i}.jsonl")))
        done = [t for t in traces if t.get("outcome") == "complete"
                and int(t.get("rid", -1)) < 1000]
        if len(done) != N_REQUESTS:
            failures.append(
                f"traces: {len(done)} completed timelines in the JSONL "
                f"streams, expected {N_REQUESTS}")
        for t in done:
            errs = validate_timeline(t)
            if errs:
                failures.append(
                    f"trace rid={t.get('rid')}: {'; '.join(errs)}")
        # The report tool's serving_slo section parses, with the ledger
        # consistent and an SLO verdict present (targets were set).
        summary = load_report_tool().summarize(
            os.path.join(tmp_on, "serve_slo_r0.jsonl"))
        ss = summary.get("serving_slo") or {}
        if not ss.get("available"):
            failures.append("serving_slo section unavailable in the "
                            "telemetry report")
        else:
            led = ss.get("ledger") or {}
            if not led.get("consistent"):
                failures.append(f"report ledger inconsistent: {led}")
            slo = ss.get("slo")
            if not isinstance(slo, dict) or not slo.get("burn"):
                failures.append(
                    f"report slo verdict missing: {slo!r} "
                    f"({ss.get('slo_unavailable_reason')})")
            tr = ss.get("traces") or {}
            if tr.get("contiguity_violations", 1) != 0:
                failures.append(
                    f"report found {tr.get('contiguity_violations')} "
                    f"timeline contiguity violation(s)")
        srv = summary.get("serving") or {}
        if "queue_wait_ms" not in srv or "service_ttft_ms" not in srv:
            failures.append("queue_wait/service_ttft split missing "
                            "from the report's serving section")
        print(f"serve_slo_check_torch: device={device}, "
              f"completed={rep_on.get('completed')}, "
              f"timelines={len(done)}, "
              f"added_device_syncs={syncs_on - syncs_off}, "
              f"slo={(ss.get('slo') or {}).get('burn')}")
    if failures:
        for f in failures:
            print(f"serve_slo_check_torch FAIL: {f}")
        return 1
    print("serve_slo_check_torch: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
