#!/usr/bin/env python3
"""Same-card comparison of two checkouts of the PyTorch port on one
NVIDIA GPU: ``chip_smoke.py``'s serving phase (gpt2-small, 16
shared-prefix requests; chunked prefill with ``spec_k`` 0 and 3, and
whole-prompt prefill) run from each checkout in turn, each turn its own
process with that checkout's kernels built.

    python3 profile_torch_ab.py --turns a:PATH_A,b:PATH_B,b:PATH_B,a:PATH_A

A checkout is a directory holding ``chip_smoke.py`` and
``deepspeed_tpu_torch/`` (``git archive`` of a commit, unpacked into a
directory ``.gitignore`` lists). Prints the card's name and power limit,
then one JSON line a turn and path (TTFT, TPOT, tokens/s and decode-step
p50), then one JSON line of the medians by side and path.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

TURN = """
import contextlib, io, torch
import chip_smoke as cs
with contextlib.redirect_stdout(io.StringIO()):
    cs.op_builder.load(verbose=True)
cs.serve_gpt2_small(torch.device("cuda"))
"""
FIELDS = ("ttft_ms_p50", "tpot_ms_p50", "tokens_per_s",
          "decode_step_ms_p50")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", required=True,
                    help="comma-separated side:checkout pairs, in order")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    by = {}
    for n, turn in enumerate(args.turns.split(","), 1):
        side, path = turn.split(":", 1)
        r = subprocess.run([sys.executable, "-c", TURN],
                           cwd=os.path.abspath(path), capture_output=True,
                           text=True, timeout=900)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            return r.returncode
        for line in r.stdout.splitlines():
            if not line.startswith('{"serve": '):
                continue             # the engines' log lines
            rec = json.loads(line)["serve"]
            row = {"turn": n, "side": side, "path": rec["path"],
                   **{f: rec[f] for f in FIELDS}}
            print(json.dumps(row), flush=True)
            for f in FIELDS:
                by.setdefault((side, str(rec["path"]), f), []).append(
                    rec[f])
    print(json.dumps({"medians": {f"{s}/{p}/{f}": statistics.median(v)
                                  for (s, p, f), v in sorted(by.items())},
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
