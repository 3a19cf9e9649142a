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

   The elastic tier (``tools/crashkill.py``'s): an uninterrupted floor
   run at another dp measures the cross-world reduction-order floor
   against the reference; then a kill/resume cycle whose segments run at
   the dp worlds of ``--worlds`` in turn (gloo process groups, a process
   a rank), its slow-write cycles landing kills mid-write; the resumed
   run must sit within ``max(10 * floor, --elastic_atol)`` of the
   reference. A SIGTERM goes to one rank (the last): the ranks agree at
   the next step boundary and save together (the collective preemption
   save); a SIGKILL takes every rank. The reference runs at the first
   world, the floor at the second. JAX cycles 8 -> 4 -> 2; the port's
   default 4 -> 2 -> 1 keeps CPU time down.

   The floor can be far larger than what the cycle adds. Adam's first
   update is ``lr * g / (|g| + eps)``, so an element whose grad cancels
   to near ``eps`` moves by a large share of ``lr`` on a reduction-order
   difference in ``g`` (in this job at dp 1 against dp 2: |g| 2.3e-8
   and 2.4e-8, a 7.3e-5 parting after one step on the CPU), and the
   later sign-like updates carry the parting on. The floor run takes
   its first steps at another dp than the reference; the cycle's first
   segment runs at the reference's dp. ``--elastic-max`` holds the
   elastic delta under a fixed bound besides the floor-derived one.

   ``bench`` (the async save's goodput share, JAX's
   ``RESILIENCE_BENCH.json``) belongs with the port's benchmark tools
   and is not ported.

2. **child** / **probe**: the subprocess bodies (a training segment that
   auto-resumes, one process a rank; the load-latest check, one
   process).

    python tools/crashkill_torch.py run --quick              # on the card
    python tools/crashkill_torch.py run --quick --device cpu
    python tools/crashkill_torch.py run --quick --device cpu --elastic-only

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
BENCH_NOT_PORTED = ("bench writes the resilience artifact that JAX's "
                    "tools/bench_gate.py gates: it goes with the port's "
                    "benchmark tools (ROADMAP item 8's note)")


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


def _engine(ckdir: str, snapshot_every: int, use_async: bool, device: str,
            world: int = 1):
    """The job's engine at dp ``world`` (the process group is up)."""
    import torch
    import deepspeed_tpu_torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    cfg = {
        "train_batch_size": GLOBAL_BATCH,
        "train_micro_batch_size_per_gpu": GLOBAL_BATCH // world,
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
    """The params and the optimizer's buffers leaf by leaf (whole at any
    dp: every rank's rows gathered), as numpy, to ``out`` on rank 0
    (collective at dp > 1)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.fused_update import tree_flatten
    from deepspeed_tpu_torch.ops.optimizers import state_buffers
    from deepspeed_tpu_torch.parallel import comm
    leaves = list(tree_flatten(eng.full_params())[0])
    for bufs in state_buffers(eng.state.opt_state).values():
        for gi, buf in enumerate(bufs):
            idxs = eng._group_leaves[gi]
            if eng._shard_local:
                lv = [torch.empty(eng._leaf_shapes[i], dtype=buf.dtype)
                      for i in idxs]
                eng._shards[gi].unpack(comm.all_gather(buf).cpu(), lv)
            else:
                lv = eng._groups[gi].views(buf)
            leaves += lv
    if eng.dp_rank == 0:
        np.savez(out, *[t.detach().cpu().numpy() for t in leaves])


def _rank_rows(batch, world: int, rank: int):
    """Rank ``rank``'s rows of a global batch (gas 1)."""
    micro = GLOBAL_BATCH // world
    return tuple(x[rank * micro:(rank + 1) * micro] for x in batch)


def _init_group(args) -> None:
    """The child's gloo group (a ``FileStore`` per segment) at dp > 1;
    on the card every rank shares the one device."""
    if args.world <= 1:
        return
    import torch.distributed as dist
    import deepspeed_tpu_torch
    deepspeed_tpu_torch.init_distributed(
        dist_backend="gloo", store=dist.FileStore(args.store, args.world),
        world_size=args.world, rank=args.rank, verbose=False)


# --------------------------------------------------------------------- #
# Subprocess bodies
# --------------------------------------------------------------------- #
def cmd_child(args) -> int:
    os.makedirs(args.dir, exist_ok=True)
    _init_group(args)
    eng = _engine(args.dir, args.snapshot_every, not args.sync, args.device,
                  args.world)
    eng.load_checkpoint(args.dir)       # no-op when nothing saved yet
    start = eng.global_steps
    print(f"CRASHKILL_START step={start} device={eng.device} "
          f"dp={args.world} rank={args.rank}", flush=True)
    progress = os.path.join(args.dir, "PROGRESS")
    for step in range(start, args.steps):
        eng.train_batch(_rank_rows(batch_for(step), args.world, args.rank))
        # The driver's beacon: kills target a STEP, not a wall-clock
        # delay (an overwrite: the last completed step).
        if args.rank == 0:
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


_SEGMENTS = [0]


def _spawn(mode: str, ckdir: str, steps: int, every: int, device: str,
           out: str = "", env_extra=None, world: int = 1):
    """One segment: ``world`` processes (a rank each, on a fresh
    ``FileStore`` beside ``ckdir``); returns the list of them."""
    _SEGMENTS[0] += 1
    store = f"{ckdir}.store{_SEGMENTS[0]}.{os.getpid()}"
    env = dict(os.environ)
    env.update(env_extra or {})
    if world > 1:
        env.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), mode,
               "--dir", ckdir, "--steps", str(steps),
               "--snapshot-every", str(every), "--device", device,
               "--world", str(world), "--rank", str(rank),
               "--store", store]
        if out:
            cmd += ["--out", out]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env))
    return procs


def _finish(procs, timeout: float):
    """Wait for a segment's processes; returns (return codes, rank 0's
    log, every rank's log)."""
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    return [p.returncode for p in procs], logs[0], "\n".join(logs)


# --------------------------------------------------------------------- #
# The harness driver
# --------------------------------------------------------------------- #
def _kill_cycle(ckdir: str, steps: int, every: int, kills: int,
                rng: random.Random, device: str, out: str,
                worlds=(1,)) -> int:
    """Kill and resume until the job completes (the completing run dumps
    its state to ``out``); segment i runs at dp ``worlds[i % len]``.
    Returns the kills landed. Asserts a loadable latest after every
    kill."""
    landed = attempt = 0
    while True:
        world = worlds[attempt % len(worlds)]
        attempt += 1
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
            procs = _spawn("child", ckdir, steps, every, device, out=out,
                           world=world)
            rcs, log, logs = _finish(procs, 600)
            if any(rcs) or "CRASHKILL_DONE" not in log:
                print(logs[-3000:])
                raise SystemExit(
                    f"final (unkilled) run failed rc={rcs}")
            print(f"  completing run: dp={world} from step {start_step}, "
                  "rc=0")
            return landed
        procs = _spawn("child", ckdir, steps, every, device,
                       env_extra=env_extra, world=world)
        sig = signal.SIGTERM if landed % 2 == 0 else signal.SIGKILL
        # A step somewhere in the remaining trajectory (never the final
        # stretch: the kill must beat completion), struck as soon as the
        # child's beacon reaches it.
        lo = start_step + 2
        hi = max(lo + 1, int(steps * 0.85))
        target = rng.randint(lo, hi)
        t0 = time.time()
        while all(p.poll() is None for p in procs) and \
                time.time() - t0 < 300:
            try:
                with open(marker) as f:
                    if int(f.read() or 0) >= target:
                        break
            except (OSError, ValueError):
                pass
            time.sleep(0.005)
        if any(p.poll() is not None for p in procs):
            rcs, _, logs = _finish(procs, 120)
            print(logs[-3000:])
            raise SystemExit(
                f"child finished before the step-{target} kill landed "
                f"(rc={rcs}): the harness proved nothing; "
                "increase --steps")
        # SIGTERM to one rank (the ranks agree and save together);
        # SIGKILL to every rank.
        for p in (procs[-1:] if sig == signal.SIGTERM else procs):
            p.send_signal(sig)
        rcs, _, logs = _finish(procs, 120)
        if all(rc == -int(sig) for rc in rcs):
            landed += 1
            print(f"  kill #{landed}: {sig.name} at step>={target} "
                  f"dp={world} rc={rcs}")
        elif all(rc in (0, -int(sig)) for rc in rcs):
            print(f"  kill raced exit: dp={world} rc={rcs}")
        else:
            print(logs[-3000:])
            raise SystemExit(f"a killed segment failed: rc={rcs}")
        # The loadable-latest probe, after EVERY kill (one process: a
        # save of any dp loads at dp 1).
        rcs, log, _ = _finish(_spawn("probe", ckdir, steps, 0, device), 300)
        if rcs[0] != 0:
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


def _uninterrupted(work: str, name: str, steps: int, every: int,
                   device: str, world: int):
    """Start an uninterrupted run at dp ``world`` (it runs beside the
    kill cycle); ``_dump_of`` waits for it and returns its dump."""
    npz = os.path.join(work, f"{name}.npz")
    return name, npz, _spawn("child", os.path.join(work, name), steps,
                             every, device, out=npz, world=world)


def _dump_of(run) -> str:
    name, npz, procs = run
    rcs, _, logs = _finish(procs, 600)
    if any(rcs):
        print(logs[-3000:])
        raise SystemExit(f"{name} run failed rc={rcs}")
    return npz


def cmd_run(args) -> int:
    rng = random.Random(args.seed)
    work = args.workdir or tempfile.mkdtemp(prefix="crashkill_")
    os.makedirs(work, exist_ok=True)
    steps, every = args.steps, args.snapshot_every
    worlds = [int(w) for w in args.worlds.split(",")]
    print(f"crashkill: steps={steps} snapshot_every={every} "
          f"device={args.device} worlds={worlds} workdir={work}")
    t0 = time.time()

    if not args.elastic_only:
        print("reference run (uninterrupted, dp=1):")
        ref = _uninterrupted(work, "ref", steps, every, args.device, 1)
        print(f"kill/resume cycle ({args.kills} kills):")
        same_npz = os.path.join(work, "same.npz")
        _kill_cycle(os.path.join(work, "same"), steps, every, args.kills,
                    rng, args.device, same_npz)
        delta = _max_delta(_dump_of(ref), same_npz)
        if delta != 0.0:
            raise SystemExit(
                f"kill/resume trajectory NOT bit-exact (max |delta| = "
                f"{delta:.3e})")
        print("  same-dp trajectory: BIT-IDENTICAL")

    if not args.no_elastic:
        # The cross-world floor, measured: an uninterrupted run at the
        # second world differs from the reference at the first by the
        # reduction order alone. The elastic run must sit within a small
        # multiple of it: the kills added no trajectory error.
        print(f"elastic reference run (uninterrupted, dp={worlds[0]}) and "
              f"cross-world floor run (uninterrupted, dp={worlds[1]}), "
              "beside the cycle")
        eref = _uninterrupted(work, "elastic_ref", steps, every,
                              args.device, worlds[0])
        floor_run = _uninterrupted(work, "floor", steps, every, args.device,
                                   worlds[1])
        print(f"elastic kill/resume cycle ({args.kills} kills, dp cycling "
              f"{' -> '.join(map(str, worlds))}):")
        el_npz = os.path.join(work, "elastic.npz")
        _kill_cycle(os.path.join(work, "elastic"), steps, every, args.kills,
                    rng, args.device, el_npz, worlds=worlds)
        eref_npz = _dump_of(eref)
        floor = _max_delta(eref_npz, _dump_of(floor_run))
        tol = max(10.0 * floor, args.elastic_atol)
        print(f"  reduction-order floor (dp={worlds[0]} vs dp={worlds[1]}, "
              f"no kills): {floor:.3e} -> tolerance {tol:.3e}")
        delta = _max_delta(eref_npz, el_npz)
        if delta == 0.0:
            print("  elastic trajectory: BIT-IDENTICAL")
        else:
            print(f"  elastic trajectory: max |delta| = {delta:.3e} "
                  f"(floor-derived tolerance {tol:.3e})")
        if delta > tol:
            raise SystemExit(
                "elastic kill/resume exceeded the reduction-order floor")
        if args.elastic_max is not None:
            print(f"  elastic delta {delta:.3e} against the fixed bound "
                  f"{args.elastic_max:.3e}")
            if delta > args.elastic_max:
                raise SystemExit(
                    "elastic kill/resume exceeded the fixed bound")
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
        p.add_argument("--world", type=int, default=1)
        p.add_argument("--rank", type=int, default=0)
        p.add_argument("--store", default="")

    common(sub.add_parser("child", help="one training segment's rank "
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
    pr.add_argument("--worlds", default="4,2,1",
                    help="the elastic cycle's dp worlds (the reference "
                         "runs at the first, the floor at the second)")
    pr.add_argument("--elastic-atol", dest="elastic_atol", type=float,
                    default=1e-6, help="the elastic tolerance's floor "
                    "(JAX's default)")
    pr.add_argument("--elastic-max", dest="elastic_max", type=float,
                    default=None, help="a fixed bound on the elastic "
                    "delta, held besides the floor-derived tolerance")
    pr.add_argument("--no-elastic", dest="no_elastic", action="store_true",
                    help="the same-dp tier only")
    pr.add_argument("--elastic-only", dest="elastic_only",
                    action="store_true", help="the elastic tier only")
    sub.add_parser("bench", help=f"not ported ({BENCH_NOT_PORTED})")

    args = ap.parse_args(argv)
    if args.mode == "child":
        return cmd_child(args)
    if args.mode == "probe":
        return cmd_probe(args)
    if args.mode == "bench":
        raise NotImplementedError(f"crashkill bench: {BENCH_NOT_PORTED}")
    if args.mode == "run":
        if args.quick:
            args.steps = min(args.steps, 300)
            args.kills = min(args.kills, 2)
        return cmd_run(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
