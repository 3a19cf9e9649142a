"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The JAX package beside it stays the reference; this package mirrors its
module names so each counterpart is easy to find. What is ported so far:

- serving: GPT-2 behind a paged, prefix-shared KV cache with chunked
  prefill, continuous batching and speculative verify (``inference/``);
- training: ``initialize()`` → ``DeepSpeedEngine.train_batch`` or the
  reference's ``forward`` / ``backward`` / ``step`` trio (and
  ``eval_batch``) with gradient accumulation, fp16 loss scaling and
  overflow skip, bf16 with fp32 masters or master-free stochastic
  rounding, clipping, LR schedules, batch-size elasticity, the fused
  one-pass Adam and the JAX package's other optimizers (Lamb, SGD,
  Adagrad, RMSprop, Lion, unfused Adam, ``torch.optim`` by name or as a
  client optimizer) (``runtime/``, ``ops/optimizers.py``), on one card
  or one process per card (``init_distributed``: data parallelism and
  ZeRO stages 0-3 over ``torch.distributed``, stage 3 with the per-layer
  prefetched scan, ``Zero3Scan``);

running on hand-written Hopper kernels for paged attention, LayerNorm
and bias+GELU forward and backward, the grad norm and the fused Adam
step (``ops/``, sources in ``csrc/``).

The package imports ``torch`` and numpy only — never JAX, flax, or any
module of ``deepspeed_tpu``. Entry points run on ``torch.device("cuda")``
unless the caller passes another device (the CPU tests pass ``"cpu"``,
where every kernel wrapper takes its plain PyTorch version).
"""
import importlib

from .version import __version__
from .utils.logging import logger, log_dist

# Names whose modules import torch load at first use, so that the
# launcher's own processes (``launcher/runner.py``, ``launcher/launch.py``)
# start without importing torch: name -> (module, attribute or None).
_LAZY = {"init_distributed": (".parallel.comm", "init_distributed"),
         "DeepSpeedConfig": (".runtime.config", "DeepSpeedConfig"),
         "lr_schedules": (".runtime.lr_schedules", None)}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    module, attr = _LAZY[name]
    value = importlib.import_module(module, __name__)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def initialize(args=None, model=None, optimizer=None, model_params=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, rng=None, device=None,
               zero3_scan=None, sparse_grad_filter=None,
               param_shardings=None, mesh=None):
    """Build the training engine (the JAX ``initialize``, non-pipeline
    branch). ``model`` is ``loss_fn(params, batch, rng)`` (for GPT-2,
    ``models.gpt2.gpt2_loss_fn(cfg)``) and ``model_params`` its param
    tree; ``config`` a ds_config dict or JSON path; ``rng`` an int seed
    or a ``torch.Generator`` on the device (dropout, stochastic
    rounding); ``device`` defaults to CUDA. Across processes, call
    ``init_distributed`` first in each: the engine takes its dp world
    and rank from the default process group, and every rank passes the
    same ``model_params`` and ``rng``. ``sparse_grad_filter(path_str,
    leaf) -> bool`` picks the leaves whose grads travel the CSR exchange
    under ``sparse_gradients`` (the path in ``jax.tree_util.keystr``
    form); by default the 2-D leaves named like an embedding.
    ``zero3_scan``: a ``runtime.zero.stage3.Zero3Scan``, the same one the
    model's loss was built with (``gpt2_loss_fn(cfg, zero3=spec)``); a
    stage-3 engine at dp > 1 binds it, and the model's layers then run
    as the per-layer prefetched scan.

    Tensor and sequence parallelism (as in JAX): ``mesh`` is a grid of
    ``parallel.topology.build_mesh(mp=, sp=)`` (every rank builds it),
    else the ds_config's ``mesh`` block builds one; the world splits as
    dp x sp x mp. ``param_shardings`` (a tree of ``parallel.topology.P``
    specs, e.g. ``models.gpt2.gpt2_param_shardings(cfg)``) places each
    leaf: each rank holds its part of the leaves split over the model
    axis. Sequence parallelism runs through the model's attention:
    ``gpt2_loss_fn(cfg, attention_fn=ops.ring_attention.
    ring_attention_fn(mesh))``.

    A ``models.gpt2_pipe.PipeSpec`` or a ``runtime.pipe.module.
    PipelineModule`` builds the ``PipelineEngine`` (the JAX dispatch):
    a PipeSpec pipelines over ``mesh.pipe_parallel_size`` stage
    processes (the process group's ranks, stage by stage), a
    PipelineModule runs composed at pp 1.

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    from .runtime.engine import DeepSpeedEngine
    from .models.gpt2_pipe import PipeSpec
    from .runtime.pipe.module import PipelineModule

    cfg = config if config is not None else config_params
    if cfg is None and args is not None:
        cfg = getattr(args, "deepspeed_config", None)
    if cfg is None:
        raise ValueError("DeepSpeed requires a config via `config=`, "
                         "`config_params=`, or args.deepspeed_config")
    if isinstance(model, (PipeSpec, PipelineModule)):
        from .runtime.pipe.engine import PipelineEngine
        if zero3_scan is not None or sparse_grad_filter is not None:
            raise ValueError("zero3_scan and sparse_grad_filter do not "
                             "compose with the pipeline engine")
        if param_shardings is not None or mesh is not None:
            from .parallel.topology import PP_MP_UNPORTED
            raise NotImplementedError(PP_MP_UNPORTED)
        pipe_mpu = mpu
        if pipe_mpu is None and isinstance(model, PipelineModule):
            pipe_mpu = model.mpu()
        engine = PipelineEngine(args=args, model=model, optimizer=optimizer,
                                model_params=model_params,
                                training_data=training_data,
                                lr_scheduler=lr_scheduler, mpu=pipe_mpu,
                                dist_init_required=dist_init_required,
                                collate_fn=collate_fn, config=cfg, rng=rng,
                                device=device)
        return (engine, engine.optimizer, engine.training_dataloader,
                engine.lr_scheduler)
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_params=model_params,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu,
                             dist_init_required=dist_init_required,
                             collate_fn=collate_fn, config=cfg, rng=rng,
                             device=device,
                             sparse_grad_filter=sparse_grad_filter,
                             zero3_scan=zero3_scan,
                             param_shardings=param_shardings, mesh=mesh)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def add_config_arguments(parser):
    """Add the ``--deepspeed`` / ``--deepspeed_config`` flags (and their
    deprecated aliases) to an ``argparse`` parser (reference
    ``__init__.py:193``)."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed (helper flag for user scripts).")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to DeepSpeed json configuration.")
    group.add_argument("--deepspeed_mpi", default=False, action="store_true",
                       help="Run via MPI; the port initializes its process "
                       "group with init_distributed.")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help="Deprecated alias for --deepspeed.")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated alias for --deepspeed_config.")
    return parser


__all__ = ["__version__", "logger", "log_dist", "initialize",
           "init_distributed", "add_config_arguments", "DeepSpeedConfig",
           "lr_schedules"]
