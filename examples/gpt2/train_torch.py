"""GPT-2 training example on the PyTorch port (``deepspeed_tpu_torch``):
``train.py``'s flags, data and stdout contract on the card's kernels.

Pick a ds_config from this directory (ZeRO-2, ZeRO-Offload, 1-bit Adam,
the pipeline with ``--pipeline``) or pass your own (``--config`` or ``--deepspeed_config``). Data defaults
to the synthetic Markov token stream; ``--data`` takes an .npy file of
int32 [N, S+1] token windows, or a .txt file (e.g. the vendored
examples/data/corpus.txt), byte-level tokenized into next-byte windows.

    python examples/gpt2/train_torch.py --config ds_config_zero2.json
    bin/deepspeed_torch --num_gpus 8 examples/gpt2/train_torch.py \\
        --pipeline --deepspeed_config examples/gpt2/ds_config_pipeline.json
    bin/deepspeed_torch --num_gpus 8 examples/gpt2/train_torch.py \\
        --deepspeed_config examples/gpt2/ds_config_zero2.json

Runs on the card (``--device cuda``, the default); ``--device cpu`` runs
the kernels' plain versions. Under the launcher (``WORLD_SIZE`` > 1) each
process brings up the process group and takes its card from
``LOCAL_RANK``. Prints ``losses:`` (the curve), ``final loss:`` and a JSON
line with the device, the kernels' launches over the training loop and
each step's wall time (rank 0).
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
from deepspeed_tpu_torch.models import GPT2_CONFIGS, gpt2_init  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import gpt2_loss_fn  # noqa: E402
from torch_example_common import (add_arguments, report,  # noqa: E402
                                  setup_device, train)


def token_windows(cfg, bs: int, data) -> np.ndarray:
    """train.py's token rows: a .txt file's bytes windowed into [N, S+1]
    (shuffled with seed 0), an .npy file, or the Markov stream."""
    S = cfg.max_seq_length
    if data and data.endswith(".txt"):
        with open(data, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        n_rows = len(raw) // (S + 1)
        assert n_rows >= bs, f"corpus too small: {len(raw)} bytes"
        tokens = raw[:n_rows * (S + 1)].reshape(n_rows, S + 1) \
            .astype(np.int32)
        rng = np.random.default_rng(0)
        return tokens[rng.permutation(n_rows)]
    if data:
        return np.load(data).astype(np.int32)
    # Markov stream: the next token is a fixed affine map of the current
    # one 90% of the time, so the loss can fall within a few dozen steps.
    rng = np.random.default_rng(0)
    n = bs * 16
    cols = [rng.integers(0, cfg.vocab_size, size=(n, 1))]
    resample = rng.random((n, S)) < 0.1
    rand = rng.integers(0, cfg.vocab_size, size=(n, S))
    for t in range(S):
        nxt = (cols[-1] * 7 + 1) % cfg.vocab_size
        cols.append(np.where(resample[:, t:t + 1], rand[:, t:t + 1], nxt))
    return np.concatenate(cols, axis=1).astype(np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ds_config_zero2.json")
    ap.add_argument("--model", default="gpt2-tiny",
                    choices=sorted(GPT2_CONFIGS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--data", default=None,
                    help="npy int32 [N, S+1], or a .txt file "
                         "(byte-level tokenized)")
    ap.add_argument("--checkpoint_dir", default=None)
    add_arguments(ap)
    args = ap.parse_args(argv)

    cfg_path = args.deepspeed_config or args.config
    if not os.path.isabs(cfg_path) and not os.path.isfile(cfg_path):
        cfg_path = os.path.join(HERE, cfg_path)
    with open(cfg_path) as f:
        ds_config = json.load(f)

    dev = setup_device(args.device)
    cfg = GPT2_CONFIGS[args.model]
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.pipeline:
        # The pipeline engine: mesh.pipe_parallel_size stage processes
        # (the launcher's ranks, stage by stage), each rank training on
        # its dp rank's rows of every micro-batch.
        from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipe_spec
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=gpt2_pipe_spec(cfg, gen, device=dev), config=ds_config,
            device=dev)
    else:
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=gpt2_loss_fn(cfg), model_params=gpt2_init(cfg, gen, dev),
            config=ds_config, device=dev)

    bs = ds_config["train_batch_size"]
    tokens = token_windows(cfg, bs, args.data)
    assert len(tokens) >= bs, \
        f"need >= {bs} rows (train_batch_size), got {len(tokens)}"
    n_windows = max(1, len(tokens) - bs + 1)

    def batches(step):
        lo = (step * bs) % n_windows
        rows = tokens[lo:lo + bs]
        if not args.pipeline:
            return rows
        # micro-batch i, dp rank d: rows i*micro*dp + d*micro onward
        micro, dp = engine.train_micro_batch_size_per_gpu(), engine.dp
        return np.concatenate([
            rows[i * micro * dp + engine.dp_rank * micro:][:micro]
            for i in range(engine.gradient_accumulation_steps())])

    losses, step_ms = train(engine, batches, args.steps)
    report("gpt2", engine, losses, step_ms)
    if args.checkpoint_dir:
        engine.save_checkpoint(args.checkpoint_dir)
    if args.pipeline and torch.distributed.is_initialized():
        # Every rank leaves together, and the stage groups go down before
        # the interpreter does (gloo aborts a process whose groups are
        # torn down at exit while a peer still talks to it).
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
