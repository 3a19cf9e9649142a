#!/usr/bin/env python3
"""Crash/kill/resume harness of the PyTorch port: preemption safety with
real signals (``tools/crashkill.py``'s loop on ``deepspeed_tpu_torch``).

1. **run** (default): train a deterministic job with auto-saves
   (``checkpoint.snapshot_every``, async writes), kill the process at a
   step drawn at random — SIGTERM (the preemption handler commits a final
   checkpoint) and SIGKILL (resume falls back to the last auto-save)
   alternating, every other kill under a slowed writer so it lands
   mid-write — probe after EVERY kill that ``latest`` names a loadable
   checkpoint (a fresh process loads it), auto-resume from ``latest``, and
   compare the killed-and-resumed run's final params and Adam moments with
   an uninterrupted run's: bit-identical (the same world size).

   The elastic tier (resume at another dp) and ``bench`` (the async
   save's goodput share on a dp-8 mesh) need the multi-process resume of
   ROADMAP queue 1 item 6 and are not ported yet.

2. **child** / **probe**: the subprocess bodies (a training segment that
   auto-resumes; the load-latest check).

    python tools/crashkill_torch.py run --quick              # on the card
    python tools/crashkill_torch.py run --quick --device cpu

The job is a small MLP whose batches are a function of the step index, so
the trajectory is a function of the step count alone: a resumed process
regenerates exactly the batches the killed one saw.
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# tools/crashkill.py's job: a step's compute above the per-step host cost,
# a snapshot of a few MB.
DIM, HIDDEN, CLASSES = 256, 1024, 16
GLOBAL_BATCH = 256
ELASTIC_NOT_PORTED = ("the elastic tier and bench mode need the "
                      "multi-process resume of ROADMAP queue 1 item 6")


def loss_fn(params, batch, rng=None):
    import torch
    x, y = batch
    h = torch.tanh(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()


def init_params(device):
    import torch
    gen = torch.Generator(device=device).manual_seed(0)
    return {
        "w1": torch.randn(DIM, HIDDEN, generator=gen, device=device) * 0.1,
        "b1": torch.zeros(HIDDEN, device=device),
        "w2": torch.randn(HIDDEN, CLASSES, generator=gen,
                          device=device) * 0.1,
        "b2": torch.zeros(CLASSES, device=device),
    }


def batch_for(step: int):
    """The batch as a function of the step index."""
    import numpy as np
    rng = np.random.default_rng(1000 + step)
    x = rng.normal(size=(GLOBAL_BATCH, DIM)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.int32) % CLASSES
    return (x, y)


def _engine(ckdir: str, snapshot_every: int, use_async: bool, device: str):
    import torch
    import deepspeed_tpu_torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    cfg = {
        "train_batch_size": GLOBAL_BATCH,
        "train_micro_batch_size_per_gpu": GLOBAL_BATCH,
        "gradient_accumulation_steps": 1,
        "zero_optimization": {"stage": 2},
        "optimizer": {"type": "Adam", "params": {"lr": 2e-2}},
        "steps_per_print": 10 ** 9,
        "checkpoint": {"async": bool(use_async),
                       "snapshot_every": int(snapshot_every),
                       "save_dir": ckdir},
    }
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_params=init_params(dev), config=cfg, device=dev)
    return engine


def _dump_state(eng, out: str):
    """The params and the optimizer's buffers, as numpy, to ``out``."""
    import numpy as np
    from torch.utils._pytree import tree_flatten
    from deepspeed_tpu_torch.ops.optimizers import state_buffers
    leaves = list(tree_flatten(eng.state.params)[0])
    for bufs in state_buffers(eng.state.opt_state).values():
        leaves += list(bufs)
    np.savez(out, *[t.detach().cpu().numpy() for t in leaves])


# --------------------------------------------------------------------- #
# Subprocess bodies
# --------------------------------------------------------------------- #
def cmd_child(args) -> int:
    os.makedirs(args.dir, exist_ok=True)
    eng = _engine(args.dir, args.snapshot_every, not args.sync, args.device)
    eng.load_checkpoint(args.dir)       # no-op when nothing saved yet
    start = eng.global_steps
    print(f"CRASHKILL_START step={start} device={eng.device}", flush=True)
    progress = os.path.join(args.dir, "PROGRESS")
    for step in range(start, args.steps):
        eng.train_batch(batch_for(step))
        # The driver's beacon: kills target a STEP, not a wall-clock
        # delay (an overwrite: the last completed step).
        with open(progress, "w") as f:
            f.write(str(step + 1))
    if eng._async_ckpt is not None:
        eng._async_ckpt.wait(timeout=120)
    if args.out:
        _dump_state(eng, args.out)
    print(f"CRASHKILL_DONE step={eng.global_steps}", flush=True)
    return 0


def cmd_probe(args) -> int:
    if not os.path.isfile(os.path.join(args.dir, "latest")):
        # A kill can land before the first save: no checkpoint is a valid
        # resume-from-scratch state, not a torn one.
        print("PROBE_EMPTY: no latest yet (resume starts fresh)")
        return 0
    eng = _engine(args.dir, 0, False, args.device)
    path, _ = eng.load_checkpoint(args.dir)
    if path is None:
        print("PROBE_FAIL: latest names no loadable checkpoint")
        return 3
    print(f"PROBE_OK step={eng.global_steps} path={path}", flush=True)
    return 0


def _spawn(mode: str, ckdir: str, steps: int, every: int, device: str,
           out: str = "", env_extra=None):
    cmd = [sys.executable, os.path.abspath(__file__), mode,
           "--dir", ckdir, "--steps", str(steps),
           "--snapshot-every", str(every), "--device", device]
    if out:
        cmd += ["--out", out]
    env = dict(os.environ)
    env.update(env_extra or {})
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)


# --------------------------------------------------------------------- #
# The harness driver
# --------------------------------------------------------------------- #
def _kill_cycle(ckdir: str, steps: int, every: int, kills: int,
                rng: random.Random, device: str, out: str) -> int:
    """Kill and resume until the job completes (the completing run dumps
    its state to ``out``); returns the kills landed. Asserts a loadable
    latest after every kill."""
    landed = 0
    while True:
        env_extra = {}
        if landed % 2 == 1:
            # Every other cycle slows the background writer so the kill
            # lands MID-WRITE with high probability.
            env_extra["DS_CKPT_TEST_WRITE_DELAY_S"] = "0.3"
        marker = os.path.join(ckdir, "PROGRESS")
        start_step = 0
        if os.path.exists(marker):
            with open(marker) as f:
                start_step = int(f.read() or 0)
            os.remove(marker)
        if landed >= kills:
            p = _spawn("child", ckdir, steps, every, device, out=out)
            log, _ = p.communicate(timeout=600)
            if p.returncode != 0 or "CRASHKILL_DONE" not in log:
                print(log[-3000:])
                raise SystemExit(
                    f"final (unkilled) run failed rc={p.returncode}")
            print(f"  completing run: from step {start_step}, rc=0")
            return landed
        p = _spawn("child", ckdir, steps, every, device, env_extra=env_extra)
        sig = signal.SIGTERM if landed % 2 == 0 else signal.SIGKILL
        # A step somewhere in the remaining trajectory (never the final
        # stretch: the kill must beat completion), struck as soon as the
        # child's beacon reaches it.
        lo = start_step + 2
        hi = max(lo + 1, int(steps * 0.85))
        target = rng.randint(lo, hi)
        t0 = time.time()
        while p.poll() is None and time.time() - t0 < 300:
            try:
                with open(marker) as f:
                    if int(f.read() or 0) >= target:
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.005)
        if p.poll() is not None:
            print(p.stdout.read()[-3000:])
            raise SystemExit(
                f"child finished before the step-{target} kill landed "
                f"(rc={p.returncode}): the harness proved nothing; "
                "increase --steps")
        p.send_signal(sig)
        p.wait(timeout=120)
        p.stdout.read()
        if p.returncode == -int(sig):
            landed += 1
            print(f"  kill #{landed}: {sig.name} at step>={target} "
                  f"rc={p.returncode}")
        else:
            print(f"  kill raced exit: rc={p.returncode}")
        # The loadable-latest probe, after EVERY kill.
        pr = _spawn("probe", ckdir, steps, 0, device)
        log, _ = pr.communicate(timeout=300)
        if pr.returncode != 0:
            print(log[-3000:])
            raise SystemExit(
                f"PROBE FAILED after kill #{landed}: latest unloadable")
        print(f"  probe: {log.strip().splitlines()[-1]}")


def _max_delta(ref_npz: str, got_npz: str) -> float:
    """0.0 iff bit-identical; else the worst absolute leaf delta."""
    import numpy as np
    ref = np.load(ref_npz)
    got = np.load(got_npz)
    assert len(ref.files) == len(got.files)
    worst = 0.0
    for k in ref.files:
        a, b = ref[k], got[k]
        if not np.array_equal(a, b):
            worst = max(worst, float(np.max(np.abs(
                a.astype(np.float64) - b.astype(np.float64)))))
    return worst


def cmd_run(args) -> int:
    rng = random.Random(args.seed)
    work = args.workdir or tempfile.mkdtemp(prefix="crashkill_")
    os.makedirs(work, exist_ok=True)
    steps, every = args.steps, args.snapshot_every
    print(f"crashkill: steps={steps} snapshot_every={every} "
          f"device={args.device} workdir={work}")
    t0 = time.time()

    print("reference run (uninterrupted):")
    ref_npz = os.path.join(work, "ref.npz")
    p = _spawn("child", os.path.join(work, "ref"), steps, every,
               args.device, out=ref_npz)
    log, _ = p.communicate(timeout=600)
    if p.returncode != 0:
        print(log[-3000:])
        raise SystemExit("reference run failed")

    print(f"kill/resume cycle ({args.kills} kills):")
    same_npz = os.path.join(work, "same.npz")
    _kill_cycle(os.path.join(work, "same"), steps, every, args.kills, rng,
                args.device, same_npz)
    delta = _max_delta(ref_npz, same_npz)
    if delta != 0.0:
        raise SystemExit(
            f"kill/resume trajectory NOT bit-exact (max |delta| = "
            f"{delta:.3e})")
    print("  same-dp trajectory: BIT-IDENTICAL")
    print(f"  elastic tier: not run ({ELASTIC_NOT_PORTED})")
    print(f"crashkill: PASS in {time.time() - t0:.1f} s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode")

    def common(p):
        p.add_argument("--dir", default="")
        p.add_argument("--steps", type=int, default=48)
        p.add_argument("--snapshot-every", type=int, default=8)
        p.add_argument("--out", default="")
        p.add_argument("--sync", action="store_true",
                       help="synchronous saves (default: async)")
        p.add_argument("--device", default="cuda")

    common(sub.add_parser("child", help="one training segment "
                          "(auto-resumes from --dir's latest)"))
    common(sub.add_parser("probe", help="assert latest is loadable"))

    pr = sub.add_parser("run", help="the kill/resume harness (default)")
    pr.add_argument("--steps", type=int, default=600)
    pr.add_argument("--snapshot-every", type=int, default=50)
    pr.add_argument("--kills", type=int, default=3)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--workdir", default="")
    pr.add_argument("--device", default="cuda")
    pr.add_argument("--quick", action="store_true",
                    help="test-sized: fewer kills, shorter job")
    sub.add_parser("bench", help=f"not ported ({ELASTIC_NOT_PORTED})")

    args = ap.parse_args(argv)
    if args.mode == "child":
        return cmd_child(args)
    if args.mode == "probe":
        return cmd_probe(args)
    if args.mode == "bench":
        raise NotImplementedError(f"crashkill bench: {ELASTIC_NOT_PORTED}")
    if args.mode == "run":
        if args.quick:
            args.steps = min(args.steps, 300)
            args.kills = min(args.kills, 2)
        return cmd_run(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
