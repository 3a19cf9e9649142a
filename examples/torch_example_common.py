"""What the port's example trainers (``examples/*/train_torch.py``)
share: the device and process group, the training loop and the stdout
contract (``losses:``, ``final loss:``, then a JSON line)."""
import json
import os
import time

import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import ops


def add_arguments(ap) -> None:
    """The flags every example takes beside its own: the launcher's
    ``--local_rank``, ``--device`` and the ds_config flags."""
    ap.add_argument("--local_rank", type=int, default=-1,
                    help="set by the launcher (the card is LOCAL_RANK's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's kernels) or cpu (their plain "
                         "versions)")
    deepspeed_tpu_torch.add_config_arguments(ap)


def setup_device(name: str) -> torch.device:
    """The run's device; with ``WORLD_SIZE`` > 1 the process group first
    (which also makes ``cuda:LOCAL_RANK`` the process's card). No card
    for a ``cuda`` run raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the kernels' plain versions")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        deepspeed_tpu_torch.init_distributed(
            dist_backend=None if dev.type == "cuda" else "gloo")
    return dev


def train(engine, batches, steps: int):
    """``steps`` train_batch calls over ``batches(step)``: the losses and
    each step's wall time in ms (reading the loss back ends the step).
    The kernels' launch counts cover exactly this loop."""
    losses, step_ms = [], []
    ops.reset_launch_counts()
    for step in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batches(step))))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


def report(example: str, engine, losses, step_ms,
           final: str = "final loss") -> None:
    """The stdout contract on rank 0: the curve, the final loss, and a
    JSON line with the device, the kernels' launches and the step
    times."""
    if engine.dp_rank != 0:
        return
    print("losses:", " ".join(f"{l:.6f}" for l in losses))
    print(f"{final}: {losses[-1]:.4f}")
    print(json.dumps({
        "example": example, "device": str(engine.device),
        "device_name": torch.cuda.get_device_name()
        if engine.device.type == "cuda" else "cpu",
        "world_size": engine.dp, "launches": ops.launch_counts(),
        "step_ms": step_ms}), flush=True)
