"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside it stays the reference; this package mirrors its
module names so each counterpart is easy to find. What is ported so far:

- serving: GPT-2 behind a paged, prefix-shared KV cache with chunked
  prefill, continuous batching and speculative verify (``inference/``);
- training: ``initialize()`` → ``DeepSpeedEngine.train_batch`` with
  gradient accumulation, fp16 loss scaling and overflow skip, bf16 with
  fp32 masters or master-free stochastic rounding, clipping, LR
  schedules and the fused one-pass Adam (``runtime/``), on one card or
  one process per card (``init_distributed``: data parallelism and ZeRO
  stages 0-3 over ``torch.distributed``);

running on hand-written Hopper kernels for paged attention, LayerNorm
and bias+GELU forward and backward, the grad norm and the fused Adam
step (``ops/``, sources in ``csrc/``).

The package imports ``torch`` and numpy only — never JAX, flax, or any
module of ``deepspeed_tpu``. Entry points run on ``torch.device("cuda")``
unless the caller passes another device (the CPU tests pass ``"cpu"``,
where every kernel wrapper takes its plain PyTorch version).
"""
from .version import __version__
from .parallel.comm import init_distributed
from .utils.logging import logger, log_dist


def initialize(args=None, model=None, optimizer=None, model_params=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, rng=None, device=None,
               zero3_scan=None):
    """Build the training engine (the JAX ``initialize``, non-pipeline
    branch). ``model`` is ``loss_fn(params, batch, rng)`` (for GPT-2,
    ``models.gpt2.gpt2_loss_fn(cfg)``) and ``model_params`` its param
    tree; ``config`` a ds_config dict or JSON path; ``rng`` an int seed
    or a ``torch.Generator`` on the device (dropout, stochastic
    rounding); ``device`` defaults to CUDA. Across processes, call
    ``init_distributed`` first in each: the engine takes its dp world
    and rank from the default process group, and every rank passes the
    same ``model_params`` and ``rng``.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    from .runtime.engine import DeepSpeedEngine

    if zero3_scan is not None:
        raise NotImplementedError(
            "zero3_scan (the per-layer prefetched stage-3 scan) is not "
            "ported yet (ROADMAP queue 1: the per-layer Zero3Scan with "
            "prefetch); stage 3 gathers every leaf per micro-step")

    cfg = config if config is not None else config_params
    if cfg is None and args is not None:
        cfg = getattr(args, "deepspeed_config", None)
    if cfg is None:
        raise ValueError("DeepSpeed requires a config via `config=`, "
                         "`config_params=`, or args.deepspeed_config")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_params=model_params,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=cfg, rng=rng,
                             device=device)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


__all__ = ["__version__", "logger", "log_dist", "initialize",
           "init_distributed"]
