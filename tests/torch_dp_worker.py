"""One rank of a data-parallel run of the port's training engine, for
``tests/test_torch_dp*.py`` (not collected by pytest: no ``test_``
prefix).

It imports torch, numpy and the port only — never JAX, which a spawned
child re-importing a test module would pull in. Usage::

    python tests/torch_dp_worker.py SPEC.json RANK
    python tests/torch_dp_worker.py SPEC.json all

``all``: one process imports once and forks the other ranks (rank 0
stays; it exits non-zero when any rank failed), what ``spawn_forked``
starts: a world's imports cost one process's CPU, not ``world``.

``SPEC.json`` holds ``world``, ``store`` (the path of a
``torch.distributed.FileStore``: no TCP port, so parallel test workers
cannot collide), ``params`` (an ``.npz`` of the initial parameters keyed
by tree path), and ``jobs``, run in order on one gloo process group:

- ``name``, ``precision`` (fp32, fp16, bf16, master_free), ``stage``,
  optional ``micro`` (rows a rank's micro-step, default 2) and ``gas``
  (micro-steps a step, default 2),
  ``batches`` (an ``.npy`` of global batches ``[steps, gas*micro*world,
  S+1]``; the rank takes its rows as the JAX engine shards them: micro
  step i, rank d → rows ``i*micro*world + d*micro`` onward), optional
  ``first``/``steps`` (which batches), ``zero`` (extra
  ``zero_optimization`` keys), ``ds`` (extra top-level keys), ``load``
  (a checkpoint dir to resume from), ``save`` (``{"dir", "after"}``:
  a sync save after that many steps, 0: before the first;
  ``"async": true`` for an async one), ``perturb`` (ranks above 0
  start from parameters moved by 0.01 * rank: the engine must
  broadcast rank 0's), ``remat`` (the model's ``remat_policy``,
  default ``none``), ``dropout`` (the model's
  hidden and attention dropout, default 0), ``trio`` (drive each step
  through ``forward``/``backward``/``step``, a call per micro-batch of
  the rank's rows, instead of ``train_batch``), ``model`` (``gpt2``, the
  default: gpt2-tiny; ``embed``: the embedding model of the sparse-
  gradient tests, ``embed_loss`` over ``embed_params``, its batches an
  ``.npz`` of ``ids`` ``[steps, N, 4]`` and ``y`` ``[steps, N, 1]``),
  ``layers`` (gpt2-tiny's layer count, default 2), ``vocab`` (its
  vocabulary, default 512), ``torch_optim`` (a client ``torch.optim``
  optimizer: ``{"name": class name, "kw": keyword arguments}``, built
  by a factory over the engine's parameters), ``moe`` (the
  ds_config ``moe`` block: gpt2-tiny with that MoE FFN in every block,
  its params' expert leaves in the ``.npz``), ``scan`` (a
  ``Zero3Scan`` for the model and ``initialize``: ``{"depth": d}``, d
  None for the config's ``prefetch_depth``), ``wait_for`` (a file the
  job waits for first, as a checkpoint another world writes),
  ``params`` (the job's own ``.npz`` of initial parameters in place of
  the spec's), ``out`` (the ``.npz`` prefix of the results). ``save``
  may also name
  ``gathered``: a second save of the same step through the rank-0
  writer (every rank's rows gathered to rank 0), the per-rank writers'
  reference. ``crash`` (``{"rank", "point", "after", "dir"}``): after
  that many steps a save in which rank ``rank`` kills itself at the
  ``async_ckpt`` crash point ``point``; each surviving rank writes
  ``{out}.rank{r}.crash`` (the save's error, or ``saved``) and exits
  at once (the job must be the last: no collective follows).

``mesh`` (``{"mp": M, "sp": S}``) runs tensor and sequence parallelism
on gpt2-tiny: the world is dp x sp x mp (rank = (d * sp + s) * mp + m,
JAX ``build_mesh``'s order), every rank builds the grid
(``topology.build_mesh``) and passes it to ``initialize`` with
``gpt2_param_shardings(cfg)`` (mp > 1), the model's attention the ring
(``ring_attention_fn``, sp > 1); each rank takes its dp rank's rows.
``model: "mpfile"`` is the plain loss of JAX's
``test_mp_sharded_model_files`` (``w [64, 8]`` split on its rows, ``b``;
batches an ``.npz`` of ``x`` and ``y``). The full parameters recorded
are the whole leaves (``engine.full_params`` gathers the model ranks'
parts). ``apply: true`` trains nothing: it writes gpt2-tiny's
``gpt2_apply`` logits on the first batch's inputs (``logits``), the
loss of ``gpt2_loss_fn`` on its rows and that loss's grads (whole,
flat, tree order: ``grads``), each rank holding its parts; and the
same for bert-tiny's MLM loss on the ``bert_inputs`` ``.npz``
(``tokens``, ``labels``) with each ``[vocab, params path]`` of
``bert`` (``bert<vocab>_loss``, ``bert<vocab>_grads``; a vocabulary
of 510 does not split at mp 4, so ``wte`` and ``decoder_bias`` stay
whole), and the largest difference of each from the whole model's in
this process (``bert_diff``).

``ring`` (the ``.npz`` of ``q``, ``k``, ``v``, ``probe``, a block
input ``x`` and the stacked params of a 2-layer block, ``blocks/...``)
trains nothing: on a ``build_mesh(sp=world)`` grid it writes
``ring_attention``'s output and the grads of ``sum(o * probe)``, causal
and not (``o1``, ``dq1``, ... / ``o0``, ...), and ``apply_blocks``'s
output with ``ring_attention_fn`` as the attention (``y``).

``serve`` (the ``inference`` block) trains nothing: gpt2-tiny (fp32)
served by ``InferenceEngine`` on a ``build_mesh(mp=, sp=)`` grid with
``gpt2_param_shardings`` (the ``mesh`` key): two prompts prefilled
(lengths 11 and 17), six decode steps (``logits``: ``[8, ...]`` rows,
``toks``), then ``serve()`` of six synthetic requests arriving at once,
greedy and at temperature 0.8 (``streams``: six rows each, the tokens
padded with -1).

``partition: true`` trains nothing: on a ``build_mesh(mp=world)`` grid
it runs a checkpointed tanh layer (``activation_checkpointing.
checkpoint_wrapper`` under ``configure(mpu=grid,
partition_activations=True)``) and the plain one on the same inputs,
writing both grads (``plain``, ``remat``) and the shapes held
(``held``).

``pipe`` runs the pipeline engine on gpt2-tiny (``initialize(model=
PipeSpec)``): ``{"stages": P, "schedule": "gpipe" | "1f1b", "remat":
the pipeline's activation_checkpoint_interval (absent: the key left
out), "stage_layers": non-uniform cuts, "hetero": true}`` (``hetero``:
the two-program ``hetero_pipe_spec`` of ``hetero_parts``); the world is
P stages of world/P dp ranks, rank = stage * dp + d, and each rank takes
its dp rank's rows. It records, besides the above, ``live`` (1F1B's
most live stage inputs), ``p2p`` (the bytes the rank sent a step),
``stage_params`` (this rank's own leaves, flat) and the whole tree's
params on rank 0 only (``params``; the digests are of the whole tree).
``save``/``load`` are the pipeline's checkpoints.

The two stage-0 train steps that replace the grad all-reduce run from
the ``ds`` keys: ``{"optimizer": {"type": "OneBitAdam", ...}}`` (1-bit
Adam: its state's ``m``/``v``/``worker_error``/``server_error`` are
written like any optimizer buffers, the worker error this rank's) and
``{"sparse_gradients": true}`` (the CSR exchange of the embedding's
grads).

Each rank writes ``{out}.rank{r}.npz``: per step the loss, grad norm,
the loss scale the step used, the skipped-step count, a digest of the
full parameters (and once: ``ws``, the telemetry meta's stage-3 gather
working set, -1 without one; ``depth``, a bound scan's depth, else -1), the sparse exchange's ``sparse_elements`` and
``dense_elements`` (-1 where it did not run) and 1-bit Adam's
``comm_bytes`` (-1 without it), and with ``moe`` the step's
``moe_expert_tokens`` (``[steps, E]``), ``moe_drop_fraction``,
``moe_aux_loss`` and ``moe_z_loss``; ``overlap_early`` (with
``overlap_comm``: the buckets the last micro-step started from its
grad hooks before the backward's last grad was in; -1 without); after
the last step the
full parameters (flat, tree order, fp32) and this rank's optimizer buffers by name and group
(the fused Adam's ``m{g}``/``v{g}``, an optax chain's ``mu{g}``,
``trace{g}``, ...; under ZeRO-Offload, ``zero: {"cpu_offload": true}``,
its partition of the host masters and moments, ``hp{i}``/``hm{i}``/
``hv{i}`` a leaf, and ``dev_param_elems``, the card's compute-dtype
parameter elements).
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from deepspeed_tpu_torch.moe.layer import MoEConfig  # noqa: E402
from deepspeed_tpu_torch.ops.fused_update import (  # noqa: E402
    tree_flatten, tree_unflatten)
from deepspeed_tpu_torch.ops.optimizers import state_buffers  # noqa: E402
from deepspeed_tpu_torch.runtime.zero.stage3 import Zero3Scan  # noqa: E402

MICRO, GAS = 2, 2
DTYPES = {"fp32": torch.float32, "fp16": torch.float16,
          "bf16": torch.bfloat16, "master_free": torch.bfloat16}


def ds_config(precision, world, stage, zero=None, extra=None, micro=MICRO,
              gas=GAS):
    """The ds_config of the dp tests (the JAX side builds the same)."""
    ds = {"train_batch_size": micro * gas * world,
          "gradient_accumulation_steps": gas,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-4, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_num_steps": 3, "warmup_max_lr": 1e-4}},
          "zero_optimization": dict({"stage": stage}, **(zero or {}))}
    if precision == "fp16":
        ds["fp16"] = {"enabled": True, "initial_scale_power": 21}
    if precision in ("bf16", "master_free"):
        ds["bf16"] = {"enabled": True,
                      "stochastic_rounding": precision == "master_free"}
    ds.update(extra or {})
    return ds


def rank_rows(batch, world, rank, micro=MICRO, gas=GAS):
    """Rank ``rank``'s rows of a global batch, micro-step by micro-step."""
    return np.concatenate([
        batch[i * micro * world + rank * micro:
              i * micro * world + (rank + 1) * micro] for i in range(gas)])


def load_params(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(z[key].copy())
    return tree


def shifted(tree, by):
    if isinstance(tree, dict):
        return {k: shifted(v, by) for k, v in tree.items()}
    return tree + by


VOCAB, HID = 512, 8


def embed_params(seed=0):
    """The embedding model's parameters (JAX ``tests/test_sparse_grads.py``
    ``model_params``)."""
    rng = np.random.default_rng(seed)
    return {"embedding": torch.from_numpy(
                (rng.standard_normal((VOCAB, HID)) * 0.1).astype(np.float32)),
            "out_w": torch.from_numpy(
                (rng.standard_normal((HID, 1)) * 0.1).astype(np.float32))}


def embed_loss(params, batch, rng):
    """A mean-pooled embedding lookup regressed onto ``y``."""
    emb = params["embedding"][batch["ids"]]           # [B, L, H]
    pred = emb.mean(dim=1) @ params["out_w"]           # [B, 1]
    return torch.mean((pred.float() - batch["y"]) ** 2)


def mpfile_params():
    """JAX ``test_mp_sharded_model_files``'s parameters."""
    return {"w": torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8),
            "b": torch.zeros(8)}


def mpfile_loss(params, batch, rng):
    """JAX ``test_mp_sharded_model_files``'s loss."""
    x, y = batch
    h = x @ params["w"][:x.shape[-1], :]
    return torch.mean((h.sum(-1) - y) ** 2)


def flat_params(eng):
    if getattr(eng, "_pipe_spec", None) is not None:
        tree = eng.whole_params()       # (a collective; rank 0 only)
        if tree is None:
            return np.zeros(0, np.float32)
        leaves = tree_flatten(tree)[0]
    else:
        leaves = tree_flatten(eng.full_params())[0]
    return np.concatenate([t.detach().float().reshape(-1).numpy()
                           for t in leaves])


def hetero_parts(H=16, P=2, seed=0):
    """The two-program pipeline of the hetero tests: a tanh stem on
    stage 0, a residual ReLU layer on the others; the embedding and the
    head are a lookup and a squared error. Returns ``(embed, head,
    programs, stage_programs, stage_params, shared)``."""
    rng = np.random.default_rng(seed)

    def stem(p, x, rng_):
        return torch.tanh(x @ p["w"] + p["b"])

    def body(p, x, rng_):
        return x + torch.relu(x @ p["w"])

    def t(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.3).astype(np.float32))

    stage_params = [{"w": t(H, H), "b": t(H)}] + \
        [{"w": t(H, H)} for _ in range(P - 1)]
    shared = {"emb": t(64, H), "out": t(H, 1)}

    def embed(sh, tokens, rng_):
        return sh["emb"][tokens[:, 0] % 64]

    def head(sh, x, targets, rng_):
        pred = x @ sh["out"]
        return torch.mean((pred[:, 0] - targets[:, 0].float() / 64) ** 2)

    return embed, head, [stem, body], [0] + [1] * (P - 1), stage_params, \
        shared


def ring_job(job, world, rank):
    """The ``ring`` job (the module docstring)."""
    from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                        apply_blocks)
    from deepspeed_tpu_torch.ops.ring_attention import (ring_attention,
                                                        ring_attention_fn)
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    grid = build_mesh(sp=world)
    z = load_params(job["ring"])
    out = {}
    for causal in (0, 1):
        qkv = [z[n].clone().requires_grad_(True) for n in "qkv"]
        o = ring_attention(*qkv, grid, causal=bool(causal))
        grads = torch.autograd.grad((o * z["probe"]).sum(), qkv)
        out[f"o{causal}"] = o.detach().numpy()
        for n, g in zip("qkv", grads):
            out[f"d{n}{causal}"] = g.numpy()
    cfg = TransformerConfig(hidden_size=32, num_heads=2, num_layers=2,
                            max_seq_length=32, hidden_dropout=0.0,
                            attn_dropout=0.0, causal=True,
                            dtype=torch.float32)
    y = apply_blocks(z["blocks"], z["x"], cfg, deterministic=True,
                     attention_fn=ring_attention_fn(grid))
    out["y"] = y.detach().numpy()
    np.savez(f"{job['out']}.rank{rank}.npz", **out)


def serve_job(job, world, rank, params):
    """The ``serve`` job (the module docstring)."""
    from deepspeed_tpu_torch.inference import InferenceEngine, scheduler
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    mesh = job.get("mesh", {})
    grid = build_mesh(mp=mesh.get("mp", 1), sp=mesh.get("sp", 1))
    cfg = dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"],
                              dtype=torch.float32)
    eng = InferenceEngine(cfg, params, config={"inference": job["serve"]},
                          device="cpu", mesh=grid,
                          param_shardings=tgpt2.gpt2_param_shardings(cfg))
    logits, toks = [], []
    for s, n in ((0, 11), (1, 17)):
        prompt = np.random.default_rng(s).integers(0, 512, n) \
            .astype(np.int32)
        tok, lg = eng.prefill(prompt, slot=s, return_logits=True)
        eng.activate_slot(s, n, tok)
        logits.append(np.asarray(lg)[None])
        toks.append([int(tok), -1])
    for _ in range(6):
        tok, lg = eng.decode_once(return_logits=True)
        logits.append(np.asarray(lg)[:2])
        toks.append([int(t) for t in np.asarray(tok)[:2]])
    for s in (0, 1):
        eng.release_slot(s)
    eng.reset_serving_stats()
    streams = np.full((12, 8), -1, np.int64)
    for k, temperature in enumerate((0.0, 0.8)):
        eng.reset_serving_stats()
        rep = eng.serve(scheduler.synthetic_requests(
            6, prompt_len=(5, 20), max_new_tokens=6, vocab_size=512,
            seed=1), temperature=temperature)
        for i, r in enumerate(rep["requests"]):
            streams[6 * k + i, :len(r["tokens"])] = r["tokens"]
    eng.close()
    np.savez(f"{job['out']}.rank{rank}.npz",
             logits=np.concatenate([np.pad(x, ((0, 2 - len(x)), (0, 0)))
                                    for x in logits]),
             toks=np.asarray(toks), streams=streams)


def partition_job(job, world, rank):
    """The ``partition`` job (the module docstring)."""
    from deepspeed_tpu_torch.parallel.topology import build_mesh
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as ck
    grid = build_mesh(mp=world)
    ck.configure(mpu=grid, partition_activations=True)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(16, 16, generator=g)
    x = torch.randn(8, 4, 16, generator=g)

    def fn(w, x):
        return torch.sum(torch.tanh(x @ w) ** 2)
    out = {}
    for name, call in (("plain", fn), ("remat", ck.checkpoint_wrapper(fn))):
        a, b = w.clone().requires_grad_(), x.clone().requires_grad_()
        grads = torch.autograd.grad(call(a, b), (a, b))
        out[name] = np.concatenate([t.reshape(-1).numpy() for t in grads])
        if name == "remat":
            out["held"] = np.asarray(sorted(str(r[2])
                                            for r in call.last_saved))
    ck.reset()
    np.savez(f"{job['out']}.rank{rank}.npz", **out)


def run_job(job, world, rank, params):
    if job.get("partition"):
        return partition_job(job, world, rank)
    if job.get("ring"):
        return ring_job(job, world, rank)
    if job.get("serve"):
        return serve_job(job, world, rank, params)
    precision = job["precision"]
    dropout = job.get("dropout", 0.0)
    micro = job.get("micro", MICRO)
    gas = job.get("gas", GAS)
    extra = dict(job.get("ds") or {})
    if job.get("moe"):
        extra["moe"] = job["moe"]
    pipe = job.get("pipe")
    dp, dp_rank = world, rank
    mesh = job.get("mesh")
    grid = shardings = None
    if mesh:
        from deepspeed_tpu_torch.parallel.topology import build_mesh
        inner = mesh.get("mp", 1) * mesh.get("sp", 1)
        dp, dp_rank = world // inner, rank // inner
        grid = build_mesh(mp=mesh.get("mp", 1), sp=mesh.get("sp", 1))
    if pipe:
        dp, dp_rank = world // pipe["stages"], rank % (
            world // pipe["stages"])
        extra["mesh"] = {"pipe_parallel_size": pipe["stages"]}
        extra["pipeline"] = {"schedule": pipe.get("schedule", "gpipe")}
        if "remat" in pipe:
            extra["pipeline"]["activation_checkpoint_interval"] = \
                pipe["remat"]
    ds = ds_config(precision, dp, job["stage"], job.get("zero"),
                   extra, micro, gas)
    if job.get("wait_for"):
        t0 = time.monotonic()
        while not os.path.exists(job["wait_for"]):
            assert time.monotonic() - t0 < 240, job["wait_for"]
            time.sleep(0.1)
    spec = None if job.get("scan") is None else \
        Zero3Scan(prefetch_depth=job["scan"].get("depth"))
    if job.get("model", "gpt2") == "embed":
        model, params = embed_loss, embed_params()
        with np.load(job["batches"]) as z:
            batches = [{"ids": i, "y": y} for i, y in zip(z["ids"], z["y"])]
    elif job.get("model") == "mpfile":
        from deepspeed_tpu_torch.parallel.topology import P
        model, params = mpfile_loss, mpfile_params()
        shardings = {"w": P("model", None), "b": P(None)}
        with np.load(job["batches"]) as z:
            batches = [(x, y) for x, y in zip(z["x"], z["y"])]
    else:
        cfg = dataclasses.replace(
            tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=DTYPES[precision],
            hidden_dropout=dropout, attn_dropout=dropout,
            remat_policy=job.get("remat", "none"),
            num_layers=job.get("layers", 2),
            vocab_size=job.get("vocab", 512),
            moe=MoEConfig(**job["moe"]) if job.get("moe") else None)
        attn = None
        if grid is not None and grid.seq_parallel_size > 1:
            from deepspeed_tpu_torch.ops.ring_attention import \
                ring_attention_fn
            attn = ring_attention_fn(grid)
        model = tgpt2.gpt2_loss_fn(cfg, attention_fn=attn, zero3=spec)
        if grid is not None and grid.model_parallel_size > 1:
            shardings = tgpt2.gpt2_param_shardings(cfg)
        batches = np.load(job["batches"])
        if pipe and pipe.get("hetero"):
            from deepspeed_tpu_torch.runtime.pipe.hetero import \
                hetero_pipe_spec
            e, h, progs, sp, stp, sh = hetero_parts(P=pipe["stages"])
            model = hetero_pipe_spec(e, h, progs, sp, stp, sh)
        elif pipe:
            from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipe_spec
            model = gpt2_pipe_spec(cfg, params=params,
                                   stage_layers=pipe.get("stage_layers"))
    if job.get("apply"):
        return apply_job(job, cfg, model, shardings, grid, params,
                         batches[0], rank)
    if job.get("perturb"):
        params = shifted(params, 0.01 * rank)
    client = None
    if job.get("torch_optim"):
        # a client torch.optim optimizer: {"name": class, "kw": kwargs}
        cls = getattr(torch.optim, job["torch_optim"]["name"])
        kw = job["torch_optim"].get("kw", {})

        def client(params):
            return cls(params, **kw)
    if pipe:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=ds, device="cpu", rng=0)
    elif client is not None:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, model_params={k: v for k, v in params.items()},
            config=ds, device="cpu", rng=0, optimizer=client)
    else:
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, model_params={k: v for k, v in params.items()},
            config=ds, device="cpu", rng=0, zero3_scan=spec, mesh=grid,
            param_shardings=shardings)
    if job.get("load"):
        assert eng.load_checkpoint(job["load"])[0] is not None
    first = job.get("first", 0)
    steps = job.get("steps", len(batches) - first)
    rec = {k: [] for k in ("loss", "grad_norm", "loss_scale", "skipped",
                           "digest", "sparse_elements", "dense_elements",
                           "comm_bytes", "overlap_early",
                           "moe_expert_tokens",
                           "moe_drop_fraction", "moe_aux_loss",
                           "moe_z_loss", "live", "p2p")}
    save = job.get("save")
    if save and save["after"] == 0:
        eng.save_checkpoint(save["dir"])      # (the state as built/loaded)
    for k in range(first, first + steps):
        if isinstance(batches[k], dict):
            rows = {n: rank_rows(x, world, rank, micro, gas)
                    for n, x in batches[k].items()}
        elif isinstance(batches[k], tuple):
            rows = tuple(torch.from_numpy(rank_rows(x, dp, dp_rank, micro,
                                                    gas))
                         for x in batches[k])
        else:
            rows = rank_rows(batches[k], dp, dp_rank, micro, gas)
        if job.get("trio"):
            for i in range(gas):
                eng.backward(eng.forward(rows[i * micro:(i + 1) * micro]))
                eng.step()
            loss = eng.last_metrics["loss"]
        else:
            loss = eng.train_batch(rows)
        m = eng.last_metrics
        rec["loss"].append(float(loss))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["loss_scale"].append(float(m["loss_scale"]))
        rec["skipped"].append(int(m["skipped_steps"]))
        rec["digest"].append(hashlib.sha256(
            flat_params(eng).tobytes()).hexdigest())
        stats = eng.sparse_comm_stats
        rec["sparse_elements"].append(stats.get("sparse_elements", -1))
        rec["dense_elements"].append(stats.get("dense_elements", -1))
        rec["comm_bytes"].append(-1 if eng.onebit_comm_bytes is None
                                 else eng.onebit_comm_bytes)
        rec["overlap_early"].append(
            -1 if eng._buckets is None else eng._buckets.early)
        if pipe:
            rec["live"].append(eng.pipe_stats.get("max_live_buffers", -1))
            rec["p2p"].append(eng.pipe_stats.get("p2p_bytes", -1))
        for name in ("moe_expert_tokens", "moe_drop_fraction",
                     "moe_aux_loss", "moe_z_loss"):
            if name in m:
                rec[name].append(m[name].numpy())
        if save and k + 1 - first == save["after"]:
            eng.save_checkpoint(save["dir"])
            if eng._async_ckpt is not None:
                eng._async_ckpt.wait()
                dist.barrier()
            if save.get("gathered"):
                # the same step through the rank-0 writer the per-rank
                # writers replaced (every rank's rows gathered to rank 0)
                eng._per_rank_writers = False
                eng.save_checkpoint(save["gathered"])
                if eng._async_ckpt is not None:
                    eng._async_ckpt.wait()
                    dist.barrier()
                eng._per_rank_writers = True
        crash = job.get("crash")
        if crash and k + 1 - first == crash["after"]:
            # One rank dies at a crash point of its commit; the sealing
            # rank's wait for its file times out. No collective follows.
            if rank == crash["rank"]:
                os.environ["DS_CKPT_CRASH_POINT"] = crash["point"]
            try:
                eng.save_checkpoint(crash["dir"])
                err = ""
            except OSError as e:
                err = str(e)
            with open(f"{job['out']}.rank{rank}.crash", "w") as f:
                f.write(err or "saved")
            os._exit(0)
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["params"] = flat_params(eng)
    if pipe:
        out["stage_params"] = np.concatenate([
            t.detach().float().reshape(-1).numpy()
            for t in tree_flatten(eng.full_params())[0]])
    out["ws"] = np.asarray(eng.telemetry.meta.get(
        "zero3_gather_working_set_bytes", -1))
    out["depth"] = np.asarray(spec.prefetch_depth if spec is not None and
                              spec.bound else -1)
    off = eng._offload
    if off is not None:
        # ZeRO-Offload: this rank's partition of the host masters and
        # moments, leaf by leaf.
        for i, (p, m, v) in enumerate(zip(off.masters, off.opt.exp_avg,
                                          off.opt.exp_avg_sq)):
            out[f"hp{i}"] = p.numpy()
            out[f"hm{i}"] = m.numpy()
            out[f"hv{i}"] = v.numpy()
        out["count"] = np.asarray(off.opt.step_count)
        out["dev_param_elems"] = np.asarray(eng._dev_params.numel())
    elif client is not None:
        out["count"] = np.asarray(eng.optimizer._count)
    else:
        st = eng.state.opt_state
        for name, bufs in state_buffers(st).items():
            for gi, b in enumerate(bufs):
                out[f"{name}{gi}"] = b.numpy()
        out["count"] = np.asarray(int(st.count))
    np.savez(f"{job['out']}.rank{rank}.npz", **out)


def apply_job(job, cfg, model, shardings, grid, params, batch, rank):
    """The ``apply`` job: logits, loss and grads through the model's
    tensor-parallel program, on this rank's parts; then bert-tiny's MLM
    loss and grads likewise, at each of the job's ``bert`` vocabularies
    (``bert_tp``)."""
    tp, local, whole = tp_grads(model, params, shardings, grid)
    tokens = torch.from_numpy(batch).long()
    logits = tgpt2.gpt2_apply(local, tokens[:, :-1], cfg, tp=tp)
    loss, grads = whole(tokens)
    out = dict(logits=logits.detach().numpy(), loss=loss, grads=grads)
    with np.load(job["bert_inputs"]) as z:
        bert_batch = (torch.from_numpy(z["tokens"]).long(),
                      torch.from_numpy(z["labels"]).long())
    diffs = []
    for vocab, path in job["bert"]:
        (out[f"bert{vocab}_loss"], out[f"bert{vocab}_grads"]), diff = \
            bert_tp(grid, load_params(path), bert_batch)
        diffs.append(diff)
    np.savez(f"{job['out']}.rank{rank}.npz", bert_diff=np.asarray(diffs),
             **out)


def tp_grads(model, params, shardings, grid):
    """This rank's parts of ``params`` under ``shardings`` (the model's
    declared leaves), and a function of the batch that returns the
    model's loss and its grads, gathered whole and flattened."""
    from deepspeed_tpu_torch.parallel import tensor_parallel as tpm
    local, tp, axes, qkv = tpm.shard_params(
        params, shardings, grid, vocab_leaves=model.vocab_leaves,
        qkv_leaves=model.qkv_leaves, own=model.param_shardings)
    leaves, td = tree_flatten(local)
    leaves = [x.requires_grad_(True) for x in leaves]
    model.tp = tp

    def whole(batch):
        loss = model(tree_unflatten(td, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [tpm.whole_leaf(torch.zeros_like(x) if g is None else g,
                                q, a, tp)
                 for x, g, q, a in zip(leaves, grads, qkv, axes)]
        return float(loss), np.concatenate(
            [g.reshape(-1).numpy() for g in grads])
    return tp, tree_unflatten(td, leaves), whole


def bert_tp(grid, params, batch):
    """bert-tiny's MLM loss and whole grads through its tensor-parallel
    program under ``bert_param_shardings`` (a vocabulary mp does not
    divide whole on every rank), and their largest difference from the
    whole model's."""
    from deepspeed_tpu_torch.models import bert as tbert
    cfg = dataclasses.replace(tbert.BERT_CONFIGS["bert-tiny"],
                              dtype=torch.float32,
                              vocab_size=params["wte"].shape[0],
                              hidden_dropout=0.0, attn_dropout=0.0)
    model = tbert.bert_mlm_loss_fn(cfg)
    loss, grads = tp_grads(model, params, tbert.bert_param_shardings(cfg),
                           grid)[2](batch)
    model.tp = None
    leaves, td = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    ref = model(tree_unflatten(td, leaves), batch)
    ref_grads = torch.autograd.grad(ref, leaves, allow_unused=True)
    ref_flat = np.concatenate([
        (torch.zeros_like(x) if g is None else g).reshape(-1).numpy()
        for x, g in zip(leaves, ref_grads)])
    diff = max(abs(loss - float(ref)), float(np.abs(grads - ref_flat).max()))
    return (loss, grads), diff


def spawn_forked(d, world, jobs, tag, params_path):
    """``tests/test_torch_dp.py``'s ``spawn`` as one process whose ranks
    are forked after the imports (``all``); returns ``[Popen]`` for its
    ``wait``."""
    store = os.path.join(str(d), f"store_{tag}")
    spec = os.path.join(str(d), f"spec_{tag}.json")
    with open(spec, "w") as f:
        json.dump(dict(world=world, store=store, params=params_path,
                       jobs=jobs), f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec, "all"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)]


def _fork_ranks(world):
    """Fork ranks 1 .. world-1 off this process; returns this process's
    rank and (rank 0) the children's pids."""
    # (what the jobs import later, imported once here)
    import torch.fx.experimental.symbolic_shapes  # noqa: F401
    from deepspeed_tpu_torch.models import gpt2_pipe  # noqa: F401
    from deepspeed_tpu_torch.runtime.pipe import engine  # noqa: F401
    sys.stdout.flush()
    pids = []
    for r in range(1, world):
        pid = os.fork()
        if pid == 0:
            return r, []
        pids.append(pid)
    return 0, pids


def main():
    spec_path = sys.argv[1]
    with open(spec_path) as f:
        spec = json.load(f)
    world = int(spec["world"])
    torch.manual_seed(0)
    torch.set_num_threads(1)
    if sys.argv[2] != "all":
        return run_rank(spec, world, int(sys.argv[2]))
    rank, pids = _fork_ranks(world)
    try:
        run_rank(spec, world, rank)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        if rank:
            os._exit(1)
        for pid in pids:
            os.kill(pid, 9)
        raise
    if rank:
        sys.stdout.flush()
        os._exit(0)
    failed = [pid for pid in pids if os.waitpid(pid, 0)[1] != 0]
    assert not failed, f"{len(failed)} forked rank(s) failed"


def run_rank(spec, world, rank):
    store = dist.FileStore(spec["store"], world)
    deepspeed_tpu_torch.init_distributed(
        dist_backend="gloo", store=store, world_size=world, rank=rank,
        verbose=False)
    params = load_params(spec["params"])
    for job in spec["jobs"]:
        run_job(job, world, rank, load_params(job["params"])
                if job.get("params") else params)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
