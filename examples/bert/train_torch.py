"""BERT masked-LM pretraining example on the PyTorch port
(``deepspeed_tpu_torch``): ``train.py``'s recipe (ZeRO-1 with the fused
Adam, bf16), synthetic MLM batches and stdout contract on the card's
kernels.

    python examples/bert/train_torch.py --steps 50 [--model bert-tiny]
    bin/deepspeed_torch --num_gpus 8 examples/bert/train_torch.py

``--deepspeed_config`` replaces the built-in ds_config; ``--device cpu``
runs the kernels' plain versions.
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
from deepspeed_tpu_torch.models.bert import (BERT_CONFIGS,  # noqa: E402
                                             bert_init, bert_mlm_loss_fn)
from torch_example_common import (add_arguments, report,  # noqa: E402
                                  setup_device, train)

DS_CONFIG = {
    "train_batch_size": 8,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 1},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
    "steps_per_print": 10,
}


def synthetic_mlm(n, cfg, mask_prob=0.15, seed=0):
    """train.py's batches: random tokens, 15% masked to [MASK] (id 3)
    with their labels, -100 elsewhere."""
    rng = np.random.default_rng(seed)
    S = cfg.max_seq_length
    tokens = rng.integers(4, cfg.vocab_size, size=(n, S)).astype(np.int32)
    labels = np.full((n, S), -100, np.int32)
    mask = rng.random((n, S)) < mask_prob
    labels[mask] = tokens[mask]
    tokens = tokens.copy()
    tokens[mask] = 3          # [MASK]
    return tokens, labels


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--model", default="bert-tiny",
                    choices=sorted(BERT_CONFIGS))
    add_arguments(ap)
    args = ap.parse_args(argv)

    ds_config = DS_CONFIG
    if args.deepspeed_config:
        with open(args.deepspeed_config) as f:
            ds_config = json.load(f)
    dev = setup_device(args.device)
    cfg = BERT_CONFIGS[args.model]
    gen = torch.Generator(device=dev).manual_seed(0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=bert_mlm_loss_fn(cfg), model_params=bert_init(cfg, gen, dev),
        config=ds_config, device=dev)

    tokens, labels = synthetic_mlm(8 * 16, cfg)

    def batches(step):
        lo = (step * 8) % (len(tokens) - 8)
        return tokens[lo:lo + 8], labels[lo:lo + 8]

    losses, step_ms = train(engine, batches, args.steps)
    report("bert", engine, losses, step_ms, final="final MLM loss")


if __name__ == "__main__":
    main()
