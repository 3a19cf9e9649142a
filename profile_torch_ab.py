#!/usr/bin/env python3
"""Same-card comparison of two checkouts of the PyTorch port on one
NVIDIA GPU: a phase of ``chip_smoke.py`` run from each checkout in turn,
each turn its own process with that checkout's kernels built.

- ``--phase serve`` (default): the serving phase (gpt2-small, 16
  shared-prefix requests; chunked prefill with ``spec_k`` 0 and 3, and
  whole-prompt prefill): TTFT, TPOT, tokens/s and decode-step p50.
- ``--phase train``: the training main path (gpt2-small, gas 2 x 8 x
  1024, bf16, 30 steps, then its fp16, master-free, sequence-768 and
  ``gelu_exact`` paths): each path's step p50.
- ``--phase moe``: ``train_moe`` (gpt2-small, 8 experts top-2, 12 bf16
  steps): its step p50; a checkout with the tile resolver resolves its
  K9 keys first, as ``chip_smoke.py`` does.

    python3 profile_torch_ab.py --turns a:PATH_A,b:PATH_B,b:PATH_B,a:PATH_A

A checkout is a directory holding ``chip_smoke.py`` and
``deepspeed_tpu_torch/`` (``git archive`` of a commit, unpacked into a
directory ``.gitignore`` lists). Prints the card's name and power limit,
then one JSON line a turn and path, then one JSON line of the medians by
side and path.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

TURNS = {
    "serve": """
import contextlib, io, torch
import chip_smoke as cs
with contextlib.redirect_stdout(io.StringIO()):
    cs.op_builder.load(verbose=True)
cs.serve_gpt2_small(torch.device("cuda"))
""",
    "train": """
import contextlib, io, subprocess, torch
import chip_smoke as cs
with contextlib.redirect_stdout(io.StringIO()):
    cs.op_builder.load(verbose=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
cs.train_gpt2_small(torch.device("cuda"), smi)
""",
    "moe": """
import contextlib, io, os, subprocess, tempfile, torch
import chip_smoke as cs
with contextlib.redirect_stdout(io.StringIO()):
    cs.op_builder.load(verbose=True)
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
dev = torch.device("cuda")
if hasattr(cs, "autotune_k9"):
    # a checkout with the tile resolver: its K9 keys resolved first, as
    # chip_smoke.py's autotune phase does before train_moe
    reg = tempfile.TemporaryDirectory()
    os.environ["DS_AUTOTUNE_REGISTRY"] = os.path.join(reg.name, "r.json")
    with contextlib.redirect_stdout(io.StringIO()):
        cs.autotune_k9(dev, torch.Generator(device=dev).manual_seed(1),
                       torch.cuda.get_device_properties(dev)
                       .multi_processor_count)
cs.train_moe(dev, smi)
"""}
SERVE_FIELDS = ("ttft_ms_p50", "tpot_ms_p50", "tokens_per_s",
                "decode_step_ms_p50")
# the training paths' records and the field read from each
TRAIN_RECORDS = ("train_path", "train_fp16_path", "train_master_free_path",
                 "train_s768_path", "train_gelu_exact_path",
                 "train_moe_path")


def rows(phase, line):
    """(path, {field: value}) of one output line, or None."""
    if not line.startswith("{"):
        return None                   # the engines' log lines
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if phase == "serve" and "serve" in rec:
        r = rec["serve"]
        return str(r["path"]), {f: r[f] for f in SERVE_FIELDS}
    if phase in ("train", "moe"):
        for name in TRAIN_RECORDS:
            if name in rec and "step_ms_p50" in rec[name]:
                return name, {"step_ms_p50": rec[name]["step_ms_p50"]}
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", required=True,
                    help="comma-separated side:checkout pairs, in order")
    ap.add_argument("--phase", choices=sorted(TURNS), default="serve")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    by = {}
    for n, turn in enumerate(args.turns.split(","), 1):
        side, path = turn.split(":", 1)
        r = subprocess.run([sys.executable, "-c", TURNS[args.phase]],
                           cwd=os.path.abspath(path), capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            return r.returncode
        for line in r.stdout.splitlines():
            got = rows(args.phase, line)
            if got is None:
                continue
            name, fields = got
            print(json.dumps({"turn": n, "side": side, "path": name,
                              **fields}), flush=True)
            for f, v in fields.items():
                by.setdefault((side, name, f), []).append(v)
    print(json.dumps({"medians": {f"{s}/{p}/{f}": statistics.median(v)
                                  for (s, p, f), v in sorted(by.items())},
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
