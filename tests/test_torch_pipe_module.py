"""The port's ``PipelineModule`` (``runtime/pipe/module.py``) against the
JAX package's, and its engine at pp 1.

- Stage boundaries: ``uniform``, ``parameters`` and ``type:regex`` equal
  JAX's for several layer lists and stage counts (and the partition
  helpers for many inputs); tied keys, owners and ``describe`` equal.
- ``to_pipe_spec``: the stacked blocks and each stage's output equal
  JAX's on the same numbers (uniform cuts; padded non-uniform cuts'
  blocks and stage sizes), and JAX's refusals with its messages.
- The engine: a ``PipelineModule`` (a tied projection at both ends, two
  dense layers between) trains 3 fp32 steps within 1e-5 of JAX's
  ``PipelineEngine``; its checkpoint is one file a layer, byte-equal to
  JAX's, and each framework resumes the other's; ``1f1b`` and pp > 1
  raise JAX's ``NotImplementedError``s.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.runtime.pipe import module as jmod
from deepspeed_tpu.runtime import utils as jutils

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.pipe import module as tmod

H = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's torch ops on one thread: the models are small, and
    under parallel test workers an intra-op team waits for cores the
    other workers' processes hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Counted:
    """A layer that reports its parameter count (both frameworks read
    ``param_count``)."""

    def __init__(self, n):
        self.n = n

    def param_count(self):
        return self.n


class Attention(Counted):
    pass


class Mlp(Counted):
    pass


class Proj:
    def __init__(self, *args):
        self.args = args


LISTS = [
    [Mlp(10), Mlp(10), Mlp(10), Mlp(10)],
    [Attention(5), Mlp(100), Attention(5), Mlp(100), Mlp(1), Mlp(1)],
    [Mlp(1), Mlp(50), Mlp(7), Attention(3), Mlp(50), Mlp(2), Mlp(9)],
]


@pytest.mark.parametrize("method", ["uniform", "parameters",
                                    "type:attention", "type:mlp"])
@pytest.mark.parametrize("li", range(len(LISTS)))
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_partitions_equal_jax(method, li, stages):
    layers = LISTS[li]
    j = jmod.PipelineModule(layers, num_stages=stages,
                            partition_method=method)
    t = tmod.PipelineModule(layers, num_stages=stages,
                            partition_method=method)
    assert t.parts == j.parts
    for i in range(len(layers)):
        assert t.stage_owner(i) == j.stage_owner(i)
    assert t.describe() == j.describe()


@pytest.mark.parametrize("seed", range(6))
def test_partition_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(1, 100, rng.integers(1, 20)).tolist()
    for parts in range(1, 6):
        assert tmod.partition_uniform(len(w), parts) == \
            jutils.partition_uniform(len(w), parts)
        assert tmod.partition_balanced(w, parts) == \
            jutils.partition_balanced(w, parts)


def _dense_t(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _dense_j(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _specs(mod):
    up = (lambda layer, p, x: x @ p["w"]) if mod is tmod else \
        (lambda layer, p, x: x @ p["w"])
    down = (lambda layer, p, x: x @ p["w"].T) if mod is tmod else \
        (lambda layer, p, x: x @ p["w"].T)
    dense = _dense_t if mod is tmod else _dense_j
    return [mod.TiedLayerSpec("emb", Proj, forward_fn=up), dense, dense,
            mod.TiedLayerSpec("emb", Proj, forward_fn=down)]


def _params(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa
    return {"tied_emb": {"w": f(H, H)},
            "layer_1": {"w": f(H, H), "b": f(H)},
            "layer_2": {"w": f(H, H), "b": f(H)}}


def test_tied_keys_equal_jax():
    j = jmod.PipelineModule(_specs(jmod), num_stages=2,
                            partition_method="uniform")
    t = tmod.PipelineModule(_specs(tmod), num_stages=2,
                            partition_method="uniform")
    assert [t.param_key(i) for i in range(4)] == \
        [j.param_key(i) for i in range(4)] == \
        ["tied_emb", "layer_1", "layer_2", "tied_emb"]
    assert t.tied_specs == j.tied_specs == {"emb": [0, 3]}
    assert isinstance(t.layers[0], Proj)


@pytest.mark.parametrize("n_layers, stages", [(4, 2), (4, 4), (6, 3)])
def test_to_pipe_spec_uniform_stage_outputs_equal_jax(n_layers, stages):
    rng = np.random.default_rng(n_layers)
    params = {f"layer_{i}": {"w": (rng.standard_normal((H, H)) * 0.3)
                             .astype(np.float32),
                             "b": rng.standard_normal(H).astype(np.float32)}
              for i in range(n_layers)}
    j = jmod.PipelineModule([_dense_j] * n_layers, num_stages=stages,
                            partition_method="uniform")
    t = tmod.PipelineModule([_dense_t] * n_layers, num_stages=stages,
                            partition_method="uniform")
    js = j.to_pipe_spec(jax.tree_util.tree_map(jnp.asarray, params),
                        head_fn=lambda sh, x, tg, r: jnp.mean(x))
    ts = t.to_pipe_spec({k: {n: torch.from_numpy(v) for n, v in d.items()}
                         for k, d in params.items()},
                        head_fn=lambda sh, x, tg, r: x.mean())
    assert ts.num_layers == js.num_layers and ts.stage_layers is None
    x = rng.standard_normal((3, H)).astype(np.float32)
    per = n_layers // stages
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for s in range(stages):
        jb = jax.tree_util.tree_map(lambda a: a[s * per:(s + 1) * per],
                                    js.params["blocks"])
        tb = {k: {n: v[s * per:(s + 1) * per] for n, v in d.items()}
              for k, d in [("", ts.params["blocks"])]}[""]
        jx = js.stage_fn(jb, jx, None)
        tx = ts.stage_fn(tb, tx, None, s)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)


def test_to_pipe_spec_non_uniform_blocks_equal_jax():
    rng = np.random.default_rng(1)
    n = 4
    params = {f"layer_{i}": {"w": rng.standard_normal((H, H))
                             .astype(np.float32),
                             "b": rng.standard_normal(H).astype(np.float32)}
              for i in range(n)}
    layers = [_dense_j] * n
    j = jmod.PipelineModule(layers, num_stages=3, partition_method="uniform")
    t = tmod.PipelineModule([_dense_t] * n, num_stages=3,
                            partition_method="uniform")
    js = j.to_pipe_spec(jax.tree_util.tree_map(jnp.asarray, params),
                        head_fn=lambda *a: 0.0)
    ts = t.to_pipe_spec({k: {m: torch.from_numpy(v) for m, v in d.items()}
                         for k, d in params.items()}, head_fn=lambda *a: 0.0)
    assert list(ts.stage_layers) == list(js.stage_layers)
    assert ts.num_layers == js.num_layers
    for k in ("w", "b"):
        np.testing.assert_array_equal(ts.params["blocks"][k].numpy(),
                                      np.asarray(js.params["blocks"][k]))
    # stage 2 holds 1 real layer and one identity slot
    x = torch.from_numpy(rng.standard_normal((2, H)).astype(np.float32))
    Lmax = max(ts.stage_layers)
    blk = {k: v[2 * Lmax:3 * Lmax] for k, v in ts.params["blocks"].items()}
    want = _dense_t({k: v[0] for k, v in blk.items()}, x)
    torch.testing.assert_close(ts.stage_fn(blk, x, None, 2), want)


def test_to_pipe_spec_refusals_equal_jax():
    cases = [
        (_specs, "tied layers cannot be auto-converted"),
        (lambda mod: [(lambda p, x: x), (lambda p, x: x)],
         "pp>1 conversion needs uniform stages"),
    ]
    for make, match in cases:
        for mod in (jmod, tmod):
            m = mod.PipelineModule(make(mod), num_stages=2,
                                   partition_method="uniform")
            keys = {m.param_key(i): {"w": np.zeros(1, np.float32)}
                    for i in range(len(m))}
            with pytest.raises(ValueError, match=match):
                m.to_pipe_spec(keys, head_fn=lambda *a: 0.0)
    for mod, fn in ((jmod, _dense_j), (tmod, _dense_t)):
        m = mod.PipelineModule([fn, fn], num_stages=2,
                               partition_method="uniform")
        with pytest.raises(ValueError, match="params is missing"):
            m.to_pipe_spec({"layer_0": {}}, head_fn=lambda *a: 0.0)


# --------------------------------------------------------------------- #
# The engine at pp 1: training, layer files, both directions
# --------------------------------------------------------------------- #
DS = {"train_batch_size": 4, "gradient_accumulation_steps": 1,
      "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
      "optimizer": {"type": "AdamW",
                    "params": {"lr": 1e-2, "weight_decay": 0.01}}}


def _jloss(x, y):
    return jnp.mean((x - y) ** 2)


def _tloss(x, y):
    return torch.mean((x - y) ** 2)


def _batches(n=3):
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((4, H)).astype(np.float32),
             rng.standard_normal((4, H)).astype(np.float32))
            for _ in range(n)]


def _jax_engine():
    m = jmod.PipelineModule(_specs(jmod), loss_fn=_jloss,
                            partition_method="uniform")
    from deepspeed_tpu.parallel.topology import build_mesh
    return deepspeed_tpu.initialize(
        model=m, model_params=jax.tree_util.tree_map(jnp.asarray, _params()),
        config=dict(DS), mesh=build_mesh(devices=jax.devices()[:1]))[0]


def _port_engine():
    m = tmod.PipelineModule(_specs(tmod), loss_fn=_tloss,
                            partition_method="uniform")
    params = {k: {n: torch.from_numpy(v.copy()) for n, v in d.items()}
              for k, d in _params().items()}
    return deepspeed_tpu_torch.initialize(model=m, model_params=params,
                                          config=dict(DS), device="cpu")[0]


def _tb(b):
    return tuple(torch.from_numpy(x) for x in b)


def _jflat(eng):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in
                           jax.tree_util.tree_leaves(
                               jax.device_get(eng.state.params))])


def _tflat(eng):
    from deepspeed_tpu_torch.ops.fused_update import tree_flatten
    return np.concatenate([t.detach().float().reshape(-1).numpy()
                           for t in tree_flatten(eng.full_params())[0]])


def test_engine_trains_as_jax_and_layer_files_cross(tmp_path):
    batches = _batches()
    je, te = _jax_engine(), _port_engine()
    assert type(te).__name__ == "PipelineEngine"
    jl = [float(je.train_batch(b)) for b in batches[:2]]
    tl = [float(te.train_batch(_tb(b))) for b in batches[:2]]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(_tflat(te), _jflat(je), atol=1e-5)
    je.save_checkpoint(str(tmp_path / "j"), tag="t")
    te.save_checkpoint(str(tmp_path / "p"), tag="t")
    jfiles = sorted(f for f in os.listdir(tmp_path / "j" / "t")
                    if f.startswith("layer_"))
    tfiles = sorted(f for f in os.listdir(tmp_path / "p" / "t")
                    if f.startswith("layer_"))
    assert jfiles == tfiles == ["layer_00-model_states.msgpack",
                                "layer_01-model_states.msgpack",
                                "layer_02-model_states.msgpack"]
    assert not (tmp_path / "p" / "t" / "mp_rank_00_model_states.msgpack") \
        .exists()
    # the port's and JAX's layer files from their own runs agree to 1e-5;
    # a port engine loaded from JAX's files writes them back byte-equal
    te2 = _port_engine()
    assert te2.load_checkpoint(str(tmp_path / "j"), tag="t")[0]
    te2.save_checkpoint(str(tmp_path / "p2"), tag="t")
    for f in jfiles:
        assert (tmp_path / "j" / "t" / f).read_bytes() == \
            (tmp_path / "p2" / "t" / f).read_bytes(), f
    # each framework resumes the other's and takes step 3 as the other
    je3 = _jax_engine()
    je3.load_checkpoint(str(tmp_path / "p"), tag="t")
    want = float(je.train_batch(batches[2]))
    assert abs(float(je3.train_batch(batches[2])) - want) <= 1e-5 * want
    got = float(te2.train_batch(_tb(batches[2])))
    assert abs(got - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose(_tflat(te2), _jflat(je), atol=1e-5)


def test_engine_refusals_as_jax():
    for sched_cfg, match in (({"pipeline": {"schedule": "1f1b"}},
                              "requires a PipeSpec model"),
                             ({"mesh": {"pipe_parallel_size": 2}},
                              "pp>1 needs an SPMD-expressible model")):
        m = tmod.PipelineModule(_specs(tmod), loss_fn=_tloss)
        with pytest.raises(NotImplementedError, match=match):
            deepspeed_tpu_torch.initialize(model=m, model_params={},
                                           config=dict(DS, **sched_cfg),
                                           device="cpu")


# --------------------------------------------------------------------- #
# The PipeSpec trees and hetero's boundary checks
# --------------------------------------------------------------------- #
def test_gpt2_pipe_tree_carries_from_jax():
    """``models/convert.from_jax_params`` carries JAX's ``{shared,
    blocks}`` tree onto the port's, leaf for leaf (the padded cuts'
    blocks: ``test_to_pipe_spec_non_uniform_blocks_equal_jax``)."""
    import dataclasses
    from deepspeed_tpu.models import gpt2 as jgpt2
    from deepspeed_tpu.models.gpt2_pipe import gpt2_pipe_spec as jspec
    from deepspeed_tpu_torch.models import convert
    from deepspeed_tpu_torch.models import gpt2 as tgpt2
    from deepspeed_tpu_torch.models.gpt2_pipe import gpt2_pipe_spec
    from deepspeed_tpu_torch.ops.fused_update import tree_flatten
    jcfg = dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"],
                               dtype=jnp.float32, num_layers=4)
    js = jspec(jcfg, rng=jax.random.PRNGKey(0))
    carried = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, js.params))
    flat = dict(carried["shared"], blocks=carried["blocks"])
    ts = gpt2_pipe_spec(dataclasses.replace(
        tgpt2.GPT2_CONFIGS["gpt2-tiny"], num_layers=4), params=flat)
    a, sa = tree_flatten(carried)
    b, sb = tree_flatten(ts.params)
    assert sa == sb and ts.num_layers == js.num_layers == 4
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_hetero_boundary_checks_equal_jax(bad):
    from deepspeed_tpu.runtime.pipe.hetero import hetero_pipe_spec as jh
    from deepspeed_tpu_torch.runtime.pipe.hetero import hetero_pipe_spec \
        as th
    x = np.ones((2, H), np.float32)

    def jprog(p, v, rng):
        return v[:, :4] if bad == "shape" else v.astype(jnp.float16)

    def tprog(p, v, rng):
        return v[:, :4] if bad == "shape" else v.to(torch.float16)
    msgs = []
    for fn, prog, sample, w in ((jh, jprog, jnp.asarray(x),
                                 jnp.ones((H,))),
                                (th, tprog, torch.from_numpy(x),
                                 torch.ones(H))):
        with pytest.raises(ValueError) as err:
            fn(lambda s, t, r: t, lambda s, v, t, r: 0.0, [prog], [0, 0],
               [{"w": w}, {"w": w}], sample_x=sample)
        msgs.append(str(err.value))
    if bad == "shape":
        assert msgs[0] == msgs[1]
    else:
        # (each names its framework's dtype: float32 -> float16)
        assert all("changes the boundary dtype" in m and "float16" in m
                   for m in msgs)
