"""Pipeline model expression (port of
``deepspeed_tpu/runtime/pipe/module.py``).

``LayerSpec`` (delayed construction), ``TiedLayerSpec`` (a layer whose
parameters are shared with every spec of the same key, e.g. a tied
embedding) and ``PipelineModule``: a model as a list of layers,
partitioned into pipeline stages by ``uniform``, ``parameters`` or
``type:regex`` (the reference's methods, over ``partition_uniform`` /
``partition_balanced``).

A layer is an ``nn.Module`` (its parameters, by ``named_parameters``
name, are the layer's tree; it runs through ``torch.func.
functional_call``) or a plain function on tensors: ``fn(params, x)``
when the engine holds parameters for it, else ``fn(x)``. The engine's
parameter tree is ``{param_key(i): layer i's tree}``; tied layers share
one key. A ``PipelineModule`` runs composed at pp 1
(``runtime/pipe/engine.py``); a pipeline of several stages takes the
uniform conversion ``to_pipe_spec`` or ``runtime/pipe/hetero.
hetero_pipe_spec``. The JAX package's ``profile`` partitioning (a layer's
cost from XLA's analytic model) has no counterpart here yet.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ...models.gpt2_pipe import PipeSpec, pad_stacked_blocks
from ...ops.fused_update import tree_flatten, tree_unflatten
from ...utils.logging import logger


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries of ``num_parts`` near-equal contiguous chunks of
    ``num_items`` (``num_parts + 1`` offsets)."""
    parts = [0] * (num_parts + 1)
    if num_items <= num_parts:
        for p in range(num_parts + 1):
            parts[p] = min(p, num_items)
        return parts
    chunksize = num_items // num_parts
    residual = num_items - (chunksize * num_parts)
    parts = list(range(0, (num_parts + 1) * chunksize, chunksize))
    for i in range(1, residual + 1):
        parts[i] += i
    for i in range(residual + 1, num_parts + 1):
        parts[i] += residual
    return parts


def _lprobe(weights: Sequence[float], num_parts: int,
            bottleneck: float) -> bool:
    parts_used, current = 1, 0.0
    for w in weights:
        if w > bottleneck:
            return False
        if current + w > bottleneck:
            parts_used += 1
            current = w
            if parts_used > num_parts:
                return False
        else:
            current += w
    return True


def partition_balanced(weights: Sequence[float], num_parts: int,
                       eps: float = 1e-3) -> List[int]:
    """Contiguous partition minimizing the largest part's weight (a
    binary search over the bottleneck, then a greedy split at it)."""
    num_items = len(weights)
    if num_items <= num_parts:
        return partition_uniform(num_items, num_parts)
    weights = [float(w) for w in weights]
    lo, hi = max(weights), sum(weights)
    while hi - lo > eps * max(1.0, lo):
        mid = (lo + hi) / 2
        if _lprobe(weights, num_parts, mid):
            hi = mid
        else:
            lo = mid
    parts, current = [0], 0.0
    for i, w in enumerate(weights):
        if current + w > hi and i > parts[-1]:
            parts.append(i)
            current = w
        else:
            current += w
    while len(parts) < num_parts + 1:
        parts.append(num_items)
    return parts[:num_parts] + [num_items]


def call_to_str(base: str, *args, **kwargs) -> str:
    inner = [repr(a) for a in args] + [f"{k}={v!r}"
                                       for k, v in kwargs.items()]
    return f"{base}({', '.join(inner)})"


class LayerSpec:
    """Delayed layer construction: a class and its arguments."""

    def __init__(self, typename, *module_args, **module_kwargs):
        if not isinstance(typename, type):
            raise RuntimeError("LayerSpec requires a class")
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self, log: bool = False):
        if log:
            logger.info(f"building {repr(self)}")
        return self.typename(*self.module_args, **self.module_kwargs)

    def __repr__(self) -> str:
        return call_to_str(self.typename.__name__, *self.module_args,
                           **self.module_kwargs)


class TiedLayerSpec(LayerSpec):
    """A layer sharing its parameters with every spec of the same
    ``key``; ``forward_fn(layer, params, x)``, when given, is how this
    use of the shared layer runs (e.g. an unembedding through the
    embedding's matrix)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="embedding", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def is_module(layer) -> bool:
    return isinstance(layer, torch.nn.Module)


def module_params(layer: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An ``nn.Module`` layer's parameter tree (detached copies)."""
    return {name: p.detach().clone()
            for name, p in layer.named_parameters()}


class PipelineModule:
    """A model as a list of layers, partitioned into pipeline stages
    (module docstring)."""

    def __init__(self, layers: Sequence[Any],
                 num_stages: Optional[int] = None, topology=None,
                 loss_fn: Optional[Callable] = None,
                 seed_layers: bool = False, base_seed: int = 1234,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0,
                 profile_input: Any = None):
        self._layer_specs = list(layers)
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.profile_input = profile_input
        self._topo = topology
        if topology is not None:
            self.num_stages = topology.get_dim("pipe")
        else:
            self.num_stages = num_stages if num_stages is not None else 1
        self.layers = [spec.build() if isinstance(spec, LayerSpec)
                       else spec for spec in self._layer_specs]
        self.parts = self._partition_layers()
        self.tied_specs: Dict[str, List[int]] = {}
        for i, spec in enumerate(self._layer_specs):
            if isinstance(spec, TiedLayerSpec):
                self.tied_specs.setdefault(spec.key, []).append(i)

    def param_key(self, layer_idx: int) -> str:
        """The parameter tree's key of a layer; tied layers share one."""
        spec = self._layer_specs[layer_idx]
        if isinstance(spec, TiedLayerSpec):
            return f"tied_{spec.key}"
        return f"layer_{layer_idx}"

    def layer_spec(self, layer_idx: int):
        return self._layer_specs[layer_idx]

    def mpu(self):
        return self._topo

    def topology(self):
        return self._topo

    def _count_layer_params(self) -> List[float]:
        counts = []
        for layer in self.layers:
            n = 0
            if hasattr(layer, "param_count"):
                n = layer.param_count()
            elif is_module(layer):
                n = sum(p.numel() for p in layer.parameters())
            elif getattr(layer, "params", None) is not None:
                n = sum(int(torch.as_tensor(x).numel())
                        for x in tree_flatten(layer.params)[0])
            counts.append(float(max(n, 1)))
        return counts

    def _partition_layers(self) -> List[int]:
        num_layers = len(self.layers)
        method = (self.partition_method or "parameters").lower()
        if method == "uniform":
            return partition_uniform(num_layers, self.num_stages)
        if method == "parameters":
            return partition_balanced(self._count_layer_params(),
                                      self.num_stages)
        if method.startswith("type:"):
            regex = method.split(":", 1)[1]
            weights = [1.0 if re.search(regex, type(l).__name__,
                                        re.IGNORECASE) else 1e-6
                       for l in self.layers]
            return partition_balanced(weights, self.num_stages)
        if method == "profile":
            raise NotImplementedError(
                'partition_method="profile" weighs each layer by XLA\'s '
                "analytic cost in the JAX package; the port has no such "
                "cost model of a layer yet (ROADMAP queue 1 item 7, the "
                "pipeline's leftovers)")
        raise KeyError(f"unknown partition method {self.partition_method}")

    def stage_layers(self, stage_id: int) -> List[Any]:
        return self.layers[self.parts[stage_id]:self.parts[stage_id + 1]]

    def stage_owner(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise IndexError(layer_idx)

    def layer_rng(self, layer_idx: int, base_rng):
        """Per-layer deterministic seeding: with ``seed_layers`` a
        generator seeded from the base one's seed and the layer (an int
        seed gives an int), else the base itself."""
        if not self.seed_layers or base_rng is None:
            return base_rng
        from ..engine import fold_in
        if isinstance(base_rng, torch.Generator):
            return torch.Generator(device=base_rng.device).manual_seed(
                fold_in(base_rng.initial_seed(),
                        self.base_seed + layer_idx))
        return fold_in(int(base_rng), self.base_seed + layer_idx)

    def __len__(self) -> int:
        return len(self.layers)

    def describe(self) -> str:
        lines = [f"PipelineModule: {len(self.layers)} layers over "
                 f"{self.num_stages} stages ({self.partition_method})"]
        for s in range(self.num_stages):
            lo, hi = self.parts[s], self.parts[s + 1]
            names = [type(l).__name__ for l in self.layers[lo:hi]]
            lines.append(f"  stage {s}: layers {lo}..{hi - 1} {names}")
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    def init_params(self) -> Dict[str, Any]:
        """The engine's parameter tree from the ``nn.Module`` layers
        (the first owner of a tied key gives its parameters); plain
        functions hold none."""
        params: Dict[str, Any] = {}
        for i, layer in enumerate(self.layers):
            key = self.param_key(i)
            if is_module(layer) and key not in params:
                params[key] = module_params(layer)
        return params

    def apply_layer(self, idx: int, p: Any, x: Any, rng: Any = None):
        """Layer ``idx`` on ``x`` with the parameters ``p``."""
        layer = self.layers[idx]
        spec = self._layer_specs[idx]
        if isinstance(spec, TiedLayerSpec) and spec.forward_fn is not None:
            return spec.forward_fn(layer, p, x)
        if is_module(layer):
            return torch.func.functional_call(layer, p, (x,))
        return layer(x) if not p else layer(p, x)

    def loss(self, params: Dict[str, Any], batch: Any, rng: Any = None):
        """The composed model (every layer in order, then ``loss_fn``):
        what the engine trains at pp 1."""
        if isinstance(batch, (tuple, list)):
            x, labels = batch[0], batch[1] if len(batch) > 1 else None
        else:
            x, labels = batch, None
        for i in range(len(self.layers)):
            x = self.apply_layer(i, params.get(self.param_key(i), {}), x,
                                 self.layer_rng(i, rng))
        return self.loss_fn(x, labels) if self.loss_fn is not None else x

    def to_pipe_spec(self, params: Dict[str, Any], embed_fn=None,
                     head_fn=None) -> PipeSpec:
        """Uniform-stage conversion to a ``PipeSpec`` (JAX's checks and
        messages): every layer the same plain ``fn(params, x)``, no tied
        layers, one parameter structure; the layers' trees stacked on a
        leading axis. Unequal stage cuts pad each stage to the longest
        (identity slots)."""
        L = len(self.layers)
        keys = [self.param_key(i) for i in range(L)]
        if len(set(keys)) != L:
            raise ValueError(
                "tied layers cannot be auto-converted to a PipeSpec; "
                "express the model as a PipeSpec with a shared param group")
        layer0 = self.layers[0]
        if is_module(layer0):
            raise ValueError(
                "to_pipe_spec converts plain fn(params, x) layers only; "
                "nn.Module layers need an explicit PipeSpec whose "
                "stage_fn calls the module")
        for i in range(L):
            if keys[i] not in params:
                raise ValueError(
                    f"params is missing '{keys[i]}' — stateless layers "
                    "(no params) cannot be pipelined via to_pipe_spec")
        code0 = getattr(layer0, "__code__", None)
        for l in self.layers[1:]:
            if l is layer0:
                continue
            same_code = code0 is not None and \
                getattr(l, "__code__", None) is code0
            closure_free = getattr(layer0, "__closure__", None) is None \
                and getattr(l, "__closure__", None) is None
            if same_code and closure_free:
                continue
            raise ValueError(
                "pp>1 conversion needs uniform stages: every layer must be "
                "the SAME function object (closures with captured state "
                "cannot be verified equal); got differing layer callables")
        trees = [params[k] for k in keys]
        spec0 = tree_flatten(trees[0])[1]
        for t in trees[1:]:
            if tree_flatten(t)[1] != spec0:
                raise ValueError("layer param trees differ in structure; "
                                 "uniform stages required for pp>1")
        flat = [tree_flatten(t)[0] for t in trees]
        blocks = tree_unflatten(spec0, [
            torch.stack([torch.as_tensor(f[j]) for f in flat])
            for j in range(len(flat[0]))])
        parts = list(self.parts)
        stage_lens = [parts[s + 1] - parts[s] for s in range(len(parts) - 1)]
        stage_valid = None
        if len(set(stage_lens)) > 1:
            blocks, valid = pad_stacked_blocks(blocks, L, stage_lens)
            Lmax = max(stage_lens)
            stage_valid = [valid[s * Lmax:(s + 1) * Lmax]
                           for s in range(len(stage_lens))]
            L = len(stage_lens) * Lmax

        def stage_fn(blocks_local, x, rng, stage):
            leaves, spec = tree_flatten(blocks_local)
            n = leaves[0].shape[0]
            run = [1.0] * n if stage_valid is None else stage_valid[stage]
            for i in range(n):
                if run[i]:
                    x = layer0(tree_unflatten(spec, [t[i] for t in leaves]),
                               x)
            return x

        if embed_fn is None:
            embed_fn = lambda shared, tokens, rng: tokens  # noqa: E731
        if head_fn is None:
            loss_head = self.loss_fn
            if loss_head is None:
                raise ValueError("PipelineModule has no loss_fn; pass "
                                 "head_fn explicitly")
            head_fn = lambda shared, x, targets, rng: \
                loss_head(x, targets)  # noqa: E731
        return PipeSpec(embed_fn=embed_fn, stage_fn=stage_fn,
                        head_fn=head_fn,
                        params={"shared": {}, "blocks": blocks},
                        num_layers=L,
                        stage_layers=(stage_lens if stage_valid is not None
                                      else None))


__all__ = ["LayerSpec", "TiedLayerSpec", "PipelineModule",
           "partition_uniform", "partition_balanced"]
