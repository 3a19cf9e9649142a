"""CIFAR-10-scale training example on the PyTorch port
(``deepspeed_tpu_torch``): ``train.py``'s small conv net (grouped matmuls
over 4x4 patches, a pooled linear head), synthetic CIFAR-shaped data and
stdout contract, driven by the ds_config.

    python examples/cifar/train_torch.py --steps 200 \\
        [--deepspeed_config ds_config.json]

``--device cpu`` runs on the CPU.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", ".."), os.path.join(HERE, "..")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import deepspeed_tpu_torch  # noqa: E402
from torch_example_common import (add_arguments, report,  # noqa: E402
                                  setup_device, train)

DS_CONFIG = {
    "train_batch_size": 64,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 20}},
    "steps_per_print": 20,
}


def net_apply(params, x):
    """3x conv (as grouped matmuls over patches) -> pooled linear head."""
    B = x.shape[0]
    h = x.reshape(B, 8, 4, 8, 4, 3).permute(0, 1, 3, 2, 4, 5)
    h = h.reshape(B, 64, 48)                      # 4x4 patches
    h = torch.tanh(h @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    h = h.mean(dim=1)                             # global average pool
    return h @ params["w3"] + params["b3"]


def init_params(generator: torch.Generator, device) -> dict:
    """train.py's shapes and scale (normal * 0.1, zero biases), drawn from
    ``generator`` (on ``device``)."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device) * 0.1
    return {"w1": normal(48, 128), "b1": torch.zeros(128, device=device),
            "w2": normal(128, 128), "b2": torch.zeros(128, device=device),
            "w3": normal(128, 10), "b3": torch.zeros(10, device=device)}


def loss_fn(params, batch, rng=None):
    x, y = batch
    logits = net_apply(params, x.to(params["w1"].dtype))
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, y.long()[:, None]).mean()


def synthetic_cifar(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    # learnable labels: class = sign pattern of channel means
    y = ((x.mean(axis=(1, 2)) > 0) * np.array([1, 2, 4])).sum(-1) % 10
    return x, y.astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    add_arguments(ap)
    args = ap.parse_args(argv)

    config = DS_CONFIG
    if args.deepspeed_config:
        with open(args.deepspeed_config) as f:
            config = json.load(f)
    dev = setup_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_params=init_params(gen, dev), config=config,
        device=dev)
    x, y = synthetic_cifar(64 * 8)

    def batches(step):
        lo = (step * 64) % (64 * 8)
        return x[lo:lo + 64], y[lo:lo + 64]

    losses, step_ms = train(engine, batches, args.steps)
    report("cifar", engine, losses, step_ms)


if __name__ == "__main__":
    main()
