"""The port's optimizer matrix (``deepspeed_tpu_torch/ops/optimizers.py``)
against the JAX package's ``build_optimizer`` (optax 0.2.6 chains).

- Updates: each optimizer's first 3 updates of a small parameter tree
  (leaves of 35, 13 and 24 elements, numpy seeds) on the same fp32
  grads, the port over one ``FlatGroup`` and JAX's ``tx.update`` +
  ``apply_updates`` leaf by leaf: the params and every state buffer
  within 4 fp32 ulp of the larger operand (of the old param, the JAX
  update and the two results; of the two buffers), and the count equal.
  The plain leaf-by-leaf ``reference_step`` (the card's yardstick for
  the flat optimizers) within the same 4 ulp of JAX on the same inputs.
  Lamb's trust-ratio clamps as ``tests/test_optimizers.py`` checks them,
  and master-free bf16 under SGD and Lamb: the port's bf16 param is one
  of the two bf16 neighbours of JAX's fp32 sum ``p + u`` (stochastic
  rounding with other noise: the port's counter hash, JAX's threefry).
- Engines: 5 steps of gpt2-tiny (gas 2, clipping 1.0, WarmupLR, dropout
  0, dense attention, the JAX engine with ``fused_kernels=False`` on a
  one-device mesh) under each optimizer against the JAX engine: fp32
  losses within 1e-5 relative and params within 1e-5 absolute; fp16
  (from initial_scale_power 20: three skips, then taken steps) losses
  within 1e-3 relative with equal loss-scale and skip sequences, params
  within 1e-3; bf16 with fp32 masters losses and params within 1e-2.
  The params' exceptions (``assert_params``): the key bias, whose
  gradient is zero in exact arithmetic, and under Lion a few signs of
  rounding-level arguments, within 2 * steps * lr.
- The name fall-through takes the ``torch.optim`` class of that name;
  over a rank's V-layout rows only an elementwise class builds, and
  a ``torch.optim`` optimizer refuses
  master-free bf16;
  a client ``torch.optim.SGD`` trains as JAX's ``optax.sgd(1e-2)``
  client within 1e-5; the K5 norm runs under every optimizer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models.transformer import dense_attention as jdense
from deepspeed_tpu.ops.optimizers import build_optimizer as jbuild
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.ops.fused_update import FlatGroup, tree_flatten
from deepspeed_tpu_torch.runtime import engine as E

from torch_cases import ulps

# (name, ds_config params) of every chain the matrix builds.
UPDATE_CASES = {
    "adamw_unfused": ("adamw", {"lr": 1e-2, "weight_decay": 0.1,
                                "fused": False}),
    "adam_unfused": ("adam", {"lr": 1e-2, "fused": False}),
    "adam_coupled_unfused": ("adam", {"lr": 1e-2, "weight_decay": 0.1,
                                      "fused": False}),
    "lamb": ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    "lamb_clamped": ("lamb", {"lr": 1e-2, "min_coeff": 0.5,
                              "max_coeff": 2.0}),
    "sgd": ("sgd", {"lr": 1e-1}),
    "sgd_momentum": ("sgd", {"lr": 1e-1, "momentum": 0.9}),
    "sgd_nesterov_wd": ("sgd", {"lr": 1e-1, "momentum": 0.9,
                                "nesterov": True, "weight_decay": 0.01}),
    "adagrad": ("adagrad", {"lr": 1e-1}),
    "rmsprop": ("rmsprop", {"lr": 1e-2}),
    "rmsprop_momentum": ("rmsprop", {"lr": 1e-2, "momentum": 0.9,
                                     "alpha": 0.9}),
    "lion": ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
}
SHAPES = {"a": (7, 5), "b": (13,), "c": {"d": (3, 4, 2)}}
ULP_TOL = 4.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread for this module: gpt2-tiny's ops
    are small, and under parallel test workers every worker's intra-op
    team would contend for the cores (the JAX side keeps its own pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _np_tree(rng, scale):
    return _tree(lambda s: (rng.standard_normal(s) * scale)
                 .astype(np.float32))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _schedule(lr):
    return lambda step: lr


def _port_group(params, dtype=torch.float32):
    leaves = [torch.from_numpy(np.asarray(x, np.float32)).to(dtype)
              for x in _leaves(params)]
    return FlatGroup(leaves, dtype, torch.device("cpu"), None)


def _within(a, b, mag, tol=ULP_TOL):
    """|a - b| within ``tol`` fp32 ulp of ``mag``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return ulps(mag, mag + np.abs(a - b), "fp32") <= tol


def _run_updates(name, master_free=False, steps=3, seed=0):
    """Both sides' params and states over ``steps`` updates of
    ``UPDATE_CASES[name]``, each update from the same inputs: before
    each step the port takes JAX's params and state (so a step's
    difference is its own, not carried from the step before)."""
    opt_name, kw = UPDATE_CASES[name]
    rng = np.random.default_rng(seed)
    p0 = _np_tree(rng, 0.5)
    grads = [_np_tree(rng, 0.1) for _ in range(steps)]
    lr = float(kw.get("lr", 1e-3))
    tx = jbuild(opt_name, dict(kw), lambda s: jnp.asarray(lr, jnp.float32))
    jdt = jnp.bfloat16 if master_free else jnp.float32
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), p0)
    jst = tx.init(jp)
    port = topt.build_optimizer(opt_name, dict(kw), _schedule(lr))
    grp = _port_group(p0, torch.bfloat16 if master_free else torch.float32)
    st = port.init([grp])
    out = []
    for k, g in enumerate(grads):
        _force(port, st, grp, jp, jst)
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        u, jst_new = tx.update(jg, jst, jp)
        if master_free:
            jsum = jax.tree_util.tree_map(
                lambda p, d: p.astype(jnp.float32) + d, jp, u)
        else:
            jsum = optax.apply_updates(jp, u)
        grp.grad.copy_(torch.cat([torch.from_numpy(x).reshape(-1)
                                  for x in _leaves(g)]))
        sr = torch.tensor(1234 + k, dtype=torch.int32) if master_free \
            else None
        st, _, _ = port.step([grp], st, compute_norm=False, sr_seed=sr)
        out.append(dict(jp=jp, g=g, u=u, jsum=jsum, jst_old=jst, jst=jst_new,
                        port=[t.detach().float().clone()
                              for t in grp.views(grp.param)],
                        st=_state_leaves(port, st, grp)))
        # JAX continues from its own result (master-free: its rounding).
        jp = jax.tree_util.tree_map(lambda p: p.astype(jdt), jsum)
        jst = jst_new
    return port, out


def _force(port, st, grp, jp, jst):
    """The port's param and state buffers := JAX's."""
    grp.param.copy_(torch.cat([
        torch.from_numpy(np.array(x, np.float32)).reshape(-1)
        for x in _leaves(jp)]).to(grp.dtype))
    it = iter(_leaves(jst))
    for entry in port.jax_layout():
        if entry == topt.COUNT:
            assert int(next(it)) == int(st.count)
            continue
        for view in grp.views(st.bufs[entry][0]):
            view.copy_(torch.from_numpy(np.array(next(it), np.float32)))


def _state_leaves(port, st, grp):
    """The port's state as JAX's leaf list (``jax_layout``), copied."""
    out = []
    for entry in port.jax_layout():
        if entry == topt.COUNT:
            out.append(np.asarray(int(st.count)))
        else:
            out += [v.numpy().copy()
                    for v in grp.views(st.bufs[entry][0])]
    return out


def _assert_states(name, k, r):
    jleaves = [np.asarray(x) for x in _leaves(r["jst"])]
    jold = [np.asarray(x, np.float32) for x in _leaves(r["jst_old"])]
    assert len(jleaves) == len(r["st"]), (name, len(jleaves), len(r["st"]))
    for a, b, o in zip(r["st"], jleaves, jold):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if b.dtype.kind == "i":
            assert int(a) == int(b) == k + 1, (name, a, b)
            continue
        mag = np.maximum.reduce([np.abs(a), np.abs(b.astype(np.float32)),
                                 np.abs(o)])
        assert _within(a, b, mag).all(), (name, k, np.abs(a - b).max())


@pytest.mark.parametrize("name", sorted(UPDATE_CASES))
def test_updates_match_optax(name):
    _, out = _run_updates(name)
    for k, r in enumerate(out):
        for leaf, (got, want, old, u) in enumerate(zip(
                r["port"], _leaves(r["jsum"]), _leaves(r["jp"]),
                _leaves(r["u"]))):
            want, got = np.asarray(want, np.float32), got.numpy()
            mag = np.maximum.reduce([np.abs(np.asarray(old, np.float32)),
                                     np.abs(u), np.abs(want), np.abs(got)])
            assert _within(got, want, mag).all(), \
                (name, k, leaf, np.abs(got - want).max())
        _assert_states(name, k, r)


def _jax_state_by_name(port, jst, n=3):
    """JAX's state leaves as ``reference_step``'s ``{name: [leaf]}``
    (``n`` parameter leaves)."""
    it = iter(_leaves(jst))
    out = {}
    for entry in port.jax_layout():
        if entry == topt.COUNT:
            next(it)
            continue
        out[entry] = [torch.from_numpy(np.array(next(it), np.float32))
                      for _ in range(n)]
    return out


@pytest.mark.parametrize("name", sorted(UPDATE_CASES))
def test_reference_step_matches_optax(name):
    """``ops/optimizers.reference_step`` (the plain leaf-by-leaf step the
    card holds the flat optimizers against) on JAX's inputs: the params
    and state within the same 4 ulp of JAX's."""
    port, out = _run_updates(name)
    for k, r in enumerate(out):
        params = [torch.from_numpy(np.array(x, np.float32))
                  for x in _leaves(r["jp"])]
        grads = [torch.from_numpy(x) for x in _leaves(r["g"])]
        new_p, new_s = topt.reference_step(
            port, params, grads, _jax_state_by_name(port, r["jst_old"]), k)
        for got, want, old, u in zip(new_p, _leaves(r["jsum"]), params,
                                     _leaves(r["u"])):
            want, got = np.asarray(want, np.float32), got.numpy()
            mag = np.maximum.reduce([np.abs(old.numpy()), np.abs(u),
                                     np.abs(want), np.abs(got)])
            assert _within(got, want, mag).all(), (name, k)
        want_s = _jax_state_by_name(port, r["jst"])
        old_s = _jax_state_by_name(port, r["jst_old"])
        for key in want_s:
            for a, b, o in zip(new_s[key], want_s[key], old_s[key]):
                a, b, o = a.numpy(), b.numpy(), o.numpy()
                mag = np.maximum.reduce([np.abs(a), np.abs(b), np.abs(o)])
                assert _within(a, b, mag).all(), (name, k, key)


@pytest.mark.parametrize("max_coeff, ratio_lo, ratio_hi",
                         [(2.0, 50, 150)])
def test_lamb_trust_ratio_clamped(max_coeff, ratio_lo, ratio_hi):
    """``tests/test_optimizers.py``'s clamp checks: large params make the
    raw trust ratio about 1000, so max_coeff sets the update's size;
    tiny params are lifted to min_coeff."""
    def upd(p_val, g_val, **kw):
        cfg = dict({"lr": 1.0, "weight_decay": 0.0}, **kw)
        port = topt.build_optimizer("lamb", cfg, _schedule(1.0))
        n = 64 if p_val == 1e-6 else 256
        grp = _port_group({"w": np.full(n, p_val, np.float32)})
        st = port.init([grp])
        grp.grad.fill_(g_val)
        old = grp.param.clone()
        port.step([grp], st, compute_norm=False)
        u_port = (grp.param - old).numpy()
        tx = jbuild("lamb", dict(cfg))
        jp = {"w": jnp.full((n,), p_val, jnp.float32)}
        u, _ = tx.update({"w": jnp.full((n,), g_val, jnp.float32)},
                         tx.init(jp), jp)
        return u_port, np.asarray(u["w"])
    small, small_j = upd(1000.0, 1e-3, max_coeff=max_coeff, min_coeff=0.01)
    big, big_j = upd(1000.0, 1e-3, max_coeff=200.0, min_coeff=0.01)
    r = np.abs(big).mean() / np.abs(small).mean()
    assert ratio_lo < r < ratio_hi, r
    # the port's param moved by JAX's update (the sum rounds at 1000)
    np.testing.assert_allclose(small, small_j, rtol=1e-3)
    np.testing.assert_allclose(big, big_j, rtol=1e-3)
    tiny, tiny_j = upd(1e-6, 1.0, min_coeff=0.5, max_coeff=10.0)
    assert np.abs(tiny).mean() > 0.4
    np.testing.assert_allclose(tiny, tiny_j, rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd_momentum", "lamb"])
def test_master_free_bf16_updates(name):
    _, out = _run_updates(name, master_free=True)
    for k, r in enumerate(out):
        for got, want in zip(r["port"], _leaves(r["jsum"])):
            want = np.asarray(want, np.float32).astype(np.float64)
            got = got.numpy().astype(np.float64)
            # one of the two bf16 values around JAX's fp32 sum (a bf16
            # ulp, widened by the sum's 4 fp32 ulp)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got - want) <= ulp * (1 + 2.0 ** -14)).all(), \
                (name, k, np.abs(got - want).max())
        _assert_states(name, k, r)


# --------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------- #
ENGINE_STEPS = 5
ENGINE_OPTIMIZERS = {
    "lamb": {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "sgd_momentum": {"type": "SGD", "params": {"lr": 1e-2,
                                               "momentum": 0.9}},
    "sgd_nesterov": {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9,
                                               "nesterov": True,
                                               "weight_decay": 0.01}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 1e-2}},
    "rmsprop": {"type": "RMSprop", "params": {"lr": 1e-4}},
    "lion": {"type": "Lion", "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "adamw_unfused": {"type": "AdamW", "params": {
        "lr": 1e-3, "weight_decay": 0.01, "fused": False}},
    "adam_unfused": {"type": "Adam", "params": {
        "lr": 1e-3, "weight_decay": 0.01, "fused": False}},
}
PRECISIONS = {"fp32": (torch.float32, jnp.float32),
              "fp16": (torch.float16, jnp.float16),
              "bf16": (torch.bfloat16, jnp.bfloat16)}


def engine_cfgs(precision, dropout=0.0):
    tdt, jdt = PRECISIONS[precision]
    off = dict(hidden_dropout=dropout, attn_dropout=dropout)
    return (dataclasses.replace(tgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=tdt,
                                **off),
            dataclasses.replace(jgpt2.GPT2_CONFIGS["gpt2-tiny"], dtype=jdt,
                                fused_kernels=False, **off))


def engine_ds(precision, optimizer, gas=2, micro=2):
    ds = {"train_batch_size": gas * micro,
          "gradient_accumulation_steps": gas,
          "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
          "optimizer": optimizer,
          "scheduler": {"type": "WarmupLR", "params": {
              "warmup_num_steps": 3,
              "warmup_max_lr": optimizer["params"]["lr"]}}}
    if precision == "fp16":
        # gpt2-tiny's first three steps overflow from 2^20, then it takes
        # steps
        ds["fp16"] = {"enabled": True, "initial_scale_power": 20}
    if precision == "bf16":
        ds["bf16"] = {"enabled": True}
    return ds


def engine_batches(steps=ENGINE_STEPS, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, (rows, 33)).astype(np.int32)
            for _ in range(steps)]


@pytest.fixture(scope="module")
def params_np():
    return jax.tree_util.tree_map(
        np.asarray, jgpt2.gpt2_init(jax.random.PRNGKey(0),
                                    engine_cfgs("fp32")[1]))


def jax_engine(precision, ds, params, optimizer=None):
    _, jcfg = engine_cfgs(precision)
    eng, *_ = deepspeed_tpu.initialize(
        model=jgpt2.gpt2_loss_fn(jcfg, attention_fn=jdense),
        model_params=jax.tree_util.tree_map(jnp.asarray, params),
        optimizer=optimizer, config=ds,
        mesh=build_mesh(devices=jax.devices()[:1]))
    return eng


def port_engine(precision, ds, params, **kw):
    """The port's engine; ``dropout`` and ``model`` (TransformerConfig
    fields) shape its model, the rest goes to ``initialize``."""
    tcfg, _ = engine_cfgs(precision, kw.pop("dropout", 0.0))
    tcfg = dataclasses.replace(tcfg, **kw.pop("model", {}))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tgpt2.gpt2_loss_fn(tcfg),
        model_params=convert.from_jax_params(params), config=ds,
        device="cpu", **kw)
    return eng


def jax_history(eng, batches):
    hist = []
    for b in batches:
        scale = float(eng.state.loss_scale)
        hist.append((float(eng.train_batch(b)), scale,
                     int(eng.state.skipped_steps)))
    return hist


def port_history(eng, batches):
    hist = []
    for b in batches:
        loss = float(eng.train_batch(b))
        m = eng.last_metrics
        hist.append((loss, float(m["loss_scale"]), int(m["skipped_steps"])))
    return hist


def flat(tree_leaves):
    return np.concatenate([
        (x.detach().float().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x, np.float32)).reshape(-1) for x in tree_leaves])


def assert_histories(precision, th, jh):
    rtol = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}[precision]
    np.testing.assert_allclose([h[0] for h in th], [h[0] for h in jh],
                               rtol=rtol)
    if precision == "fp16":
        assert [h[1:] for h in th] == [h[1:] for h in jh], (th, jh)


def assert_params(precision, teng, jeng, lr, sign_flips=False,
                  steps=ENGINE_STEPS):
    """The final params within the precision's tolerance (fp32 1e-5, fp16
    1e-3, bf16 1e-2 absolute), but for two kinds of element where two
    correct implementations part by O(lr):

    - the key bias (``qkv_bias[:, H:2H]``): its gradient is zero in
      exact arithmetic (the softmax ignores a score shift shared by every
      key), so both sides' gradients are rounding noise, which Adam's
      ``m / sqrt(v)`` and Lion's sign turn into updates of up to lr;
    - under Lion (``sign_flips``), at most 0.01% of the others: a sign
      taken of an argument at rounding level.

    Those stay within 2 * steps * lr of each other."""
    atol = {"fp32": 1e-5, "fp16": 1e-3, "bf16": 1e-2}[precision]
    bound = 2 * steps * lr
    H = engine_cfgs("fp32")[0].hidden_size
    jleaves = jax.tree_util.tree_leaves(jax.device_get(jeng.state.params))
    flips = total = 0
    for path, a, b in zip(E._leaf_paths(teng.state.params),
                          tree_flatten(teng.state.params)[0], jleaves):
        d = np.abs(flat([a]) - flat([b])).reshape(tuple(a.shape))
        if path.endswith("qkv_bias"):
            assert (d[..., H:2 * H] <= bound).all(), (path, d.max())
            d = np.concatenate([d[..., :H], d[..., 2 * H:]], axis=-1)
        bad = d > atol
        total += d.size
        flips += int(bad.sum())
        assert (d[bad] <= bound).all(), (path, d.max())
        if not sign_flips:
            assert not bad.any(), (path, d.max(), int(bad.sum()))
    assert flips <= 1e-4 * total, (flips, total)


@pytest.mark.parametrize("precision", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("name", sorted(ENGINE_OPTIMIZERS))
def test_engine_matches_jax(name, precision, params_np):
    opt = ENGINE_OPTIMIZERS[name]
    ds = engine_ds(precision, opt)
    batches = engine_batches()
    jeng = jax_engine(precision, ds, params_np)
    jh = jax_history(jeng, batches)
    teng = port_engine(precision, ds, params_np)
    th = port_history(teng, batches)
    assert_histories(precision, th, jh)
    if precision == "fp16":
        # skipped steps, then taken ones (whose lr comes from the
        # optimizer's own count, held through the skips)
        assert jh[0][2] >= 1 and jh[-1][2] < ENGINE_STEPS, jh
    assert_params(precision, teng, jeng, opt["params"]["lr"],
                  sign_flips=name == "lion")


def test_engine_runs_sqnorm_under_every_optimizer(params_np):
    """K5 (its CPU plain version here) runs once a step under every
    optimizer: the clip and the overflow vote read it."""
    for name in ("lamb", "sgd_momentum", "adagrad", "rmsprop", "lion"):
        eng = port_engine("fp32", engine_ds("fp32",
                                            ENGINE_OPTIMIZERS[name]),
                          params_np)
        calls = []
        orig = topt.sqnorm

        def counting(g):
            calls.append(g.numel())
            return orig(g)
        topt.sqnorm = counting
        try:
            eng.train_batch(engine_batches(1)[0])
        finally:
            topt.sqnorm = orig
        assert len(calls) == 1, calls
        assert float(eng.last_metrics["grad_norm"]) > 0


def test_name_fall_through_takes_torch_optim(params_np):
    ds = engine_ds("fp32", {"type": "Adamax", "params": {"lr": 1e-3}})
    eng = port_engine("fp32", ds, params_np)
    assert isinstance(eng.optimizer, topt.TorchOptimizer)
    assert type(eng.optimizer.opt) is torch.optim.Adamax
    losses = [float(eng.train_batch(b)) for b in engine_batches(5)]
    assert all(np.isfinite(losses))
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.build_optimizer("nosuchoptimizer", {}, None)
    with pytest.raises(ValueError, match="JAX checkpoint layout"):
        eng.save_checkpoint("/nonexistent-dir-never-written")


def test_torch_optim_needs_whole_fp32_params():
    """A torch.optim optimizer holds per-parameter state: over a rank's
    V-layout rows (ZeRO 1-3 across ranks) only an elementwise class
    steps its part of each leaf (Adamax builds; Adafactor, whose step
    reads a leaf's rows and columns, refuses, naming ZeRO stage 0); bf16
    params without masters are refused (tests/test_torch_optim_zero.py
    trains the elementwise classes at ZeRO 1-3)."""
    from deepspeed_tpu_torch.ops.fused_update import ShardGroup
    from deepspeed_tpu_torch.runtime.zero.partition import row_plan
    opt = topt.build_optimizer("adamax", {"lr": 1e-3}, None)
    sg = ShardGroup([(7, 5), (13,)], torch.float32, torch.device("cpu"),
                    row_plan(2, 1))
    opt.init([sg])
    assert type(opt.opt) is torch.optim.Adamax and len(opt._leaves) == 2
    opt = topt.build_optimizer("adafactor", {"lr": 1e-3}, None)
    with pytest.raises(NotImplementedError, match="ZeRO stage 0"):
        opt.init([sg])
    bf16 = _port_group({"w": np.ones(4, np.float32)}, torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 master"):
        opt.init([bf16])


def test_client_torch_sgd_matches_optax_client(params_np):
    """The reference's form (a torch.optim class) against the JAX
    engine's client ``optax.sgd(1e-2)``: 5 fp32 steps within 1e-5."""
    ds = engine_ds("fp32", {"type": "SGD", "params": {"lr": 1e-2}})
    del ds["scheduler"]
    batches = engine_batches()
    jeng = jax_engine("fp32", ds, params_np, optimizer=optax.sgd(1e-2))
    jh = jax_history(jeng, batches)
    for client in (torch.optim.SGD,
                   lambda params: torch.optim.SGD(params, lr=1e-2)):
        teng = port_engine("fp32", ds, params_np, optimizer=client)
        th = port_history(teng, batches)
        assert_histories("fp32", th, jh)
        assert_params("fp32", teng, jeng, 1e-2)


def test_client_port_optimizer_forms(params_np):
    """An instance of the port's interface, and callable(schedule_fn)
    returning one, train as the ds_config's SGD; anything else raises
    a TypeError."""
    ds = engine_ds("fp32", {"type": "SGD", "params": {"lr": 1e-2,
                                                      "momentum": 0.9}})
    batches = engine_batches(3)
    want = port_history(port_engine("fp32", ds, params_np), batches)
    got = port_history(port_engine(
        "fp32", ds, params_np,
        optimizer=lambda sched: topt.SGD(sched, momentum=0.9)), batches)
    assert got == want
    # An instance carries its own (constant) learning rate.
    inst = port_history(port_engine(
        "fp32", ds, params_np, optimizer=topt.SGD(1e-2, momentum=0.9)),
        batches)
    assert all(np.isfinite([h[0] for h in inst])) and inst != want
    for bad in (object(), 3, torch.optim.SGD([torch.zeros(1)], lr=0.1)):
        with pytest.raises(TypeError, match="optimizer must be"):
            port_engine("fp32", ds, params_np, optimizer=bad)
