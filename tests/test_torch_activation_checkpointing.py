"""The port's module-level activation checkpointing API
(``runtime/activation_checkpointing/checkpointing.py``) as the JAX
package's ``tests/test_activation_checkpointing.py`` checks its own:
the checkpointed call's gradients against the plain call's (here bit
for bit: the backward pass is autograd's graph of the same forward),
the random draws replayed, ``partition_activations`` (the identity at a
model-parallel size of 1; at 2 each rank holds its slices, whose
backward across two ranks is in tests/test_torch_tp_checkpoint.py),
``cpu_checkpointing`` holding the residuals
on the host, and ``configure``/``is_configured``/``reset``; the config
section against the JAX package's.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.activation_checkpointing import \
    checkpointing as jck
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ck


@pytest.fixture(autouse=True)
def _reset():
    ck.reset()
    yield
    ck.reset()


def _fn(w, x, gen):
    """A tanh layer with two dropout-like draws: one from a generator
    argument, one from torch's global generator."""
    h = torch.tanh(x @ w)
    h = h * (torch.rand(h.shape, generator=gen) < 0.8)
    h = h * (torch.rand(h.shape) < 0.9)
    return torch.sum(h ** 2)


def _data(seed=0, b=8, d=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(d, d, generator=g).requires_grad_(),
            torch.randn(b, 4, d, generator=g).requires_grad_())


def _grads(call, w, x, seed=3):
    torch.manual_seed(seed)
    out = call(w, x, torch.Generator().manual_seed(seed))
    torch.manual_seed(seed + 100)        # later draws must not matter
    return out.detach(), torch.autograd.grad(out, (w, x))


def test_checkpoint_matches_plain():
    w, x = _data()
    out, plain = _grads(_fn, w, x)
    wrapped = ck.checkpoint_wrapper(_fn)
    out2, remat = _grads(wrapped, w, x)
    assert torch.equal(out, out2)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    # the float inputs are the residuals; nothing else is held
    assert sorted(r[0] for r in wrapped.last_saved) == [0, 1]


def test_rng_replay_reproducible():
    w, x = _data(1)
    wrapped = ck.checkpoint_wrapper(_fn)
    g1 = _grads(wrapped, w, x, seed=5)[1]
    g2 = _grads(wrapped, w, x, seed=5)[1]
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_partitioned_checkpoint_is_the_identity_at_mp1():
    ck.configure(partition_activations=True)
    w, x = _data(2)
    plain = _grads(_fn, w, x)[1]
    remat = _grads(ck.checkpoint_wrapper(_fn), w, x)[1]
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)

    class MP2:
        def get_model_parallel_world_size(self):
            return 2

        def get_model_parallel_rank(self):
            return 1

        def get_model_parallel_group(self):
            return None
    # At mp 2 the path runs: the forward holds rank 1's halves along JAX's
    # _default_spec dim (the sequence dim of x, dim 0 of w).
    ck.configure(mpu=MP2(), partition_activations=True)
    wrapped = ck.checkpoint_wrapper(_fn)
    torch.manual_seed(3)
    out = wrapped(w, x, torch.Generator().manual_seed(3))
    torch.manual_seed(3)
    assert torch.equal(out, _fn(w, x, torch.Generator().manual_seed(3)))
    assert {r[0]: r[2] for r in wrapped.last_saved} == {0: (8, 16),
                                                        1: (8, 2, 16)}


def test_cpu_offload_checkpoint():
    ck.configure(checkpoint_in_cpu=True)
    w, x = _data(3)
    plain = _grads(_fn, w, x)[1]
    wrapped = ck.checkpoint_wrapper(_fn)
    remat = _grads(wrapped, w, x)[1]
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    saved = {r[0]: r[1:] for r in wrapped.last_saved}
    assert saved == {0: ("cpu", (16, 16), False), 1: ("cpu", (8, 4, 16),
                                                      False)}


def test_cpu_offload_of_a_strided_input():
    """An input that is a view (a transpose, an offset slice) is held as
    the span of storage it covers and comes back with its strides."""
    ck.configure(checkpoint_in_cpu=True)
    base = torch.randn(20, 16, generator=torch.Generator().manual_seed(4))
    w = base[2:18].t().detach().requires_grad_()
    w2 = w.detach().clone().requires_grad_()
    x = _data(4)[1]
    plain = _grads(_fn, w2, x)[1]
    remat = _grads(ck.checkpoint_wrapper(_fn), w, x)[1]
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_module_level_checkpoint_api():
    w, x = _data(4)
    ck.configure()
    torch.manual_seed(0)
    out = ck.checkpoint(_fn, w, x, torch.Generator().manual_seed(1))
    torch.manual_seed(0)
    want = _fn(w, x, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(out.detach()), float(want.detach()),
                               rtol=1e-6)
    assert ck.is_configured()
    ck.reset()
    assert not ck.is_configured()


def test_configure_reads_the_ds_config_section():
    ds = {"train_batch_size": 8, "activation_checkpointing": {
        "partition_activations": True, "cpu_checkpointing": True,
        "contiguous_memory_optimization": True, "number_checkpoints": 4,
        "synchronize_checkpoint_boundary": True, "profile": True}}
    tc = tconfig.DeepSpeedConfig(ds, world_size=1)
    jc = jconfig.DeepSpeedConfig(ds, world_size=1)
    assert vars(tc.activation_checkpointing_config) == \
        vars(jc.activation_checkpointing_config)
    ck.configure(deepspeed_config=tc)
    jck.configure(deepspeed_config=jc)
    try:
        for key in ("partition_activations", "cpu_checkpointing",
                    "configured"):
            assert ck._config[key] == jck._config[key]
    finally:
        jck.reset()
    # explicit flags win, as in JAX
    ck.configure(deepspeed_config=tc, checkpoint_in_cpu=False)
    assert ck._config["cpu_checkpointing"] is False


def test_a_checkpointed_block_of_ops_that_saves_its_own_output():
    """Ops that save their outputs (softmax, tanh) and non-float
    arguments (an index tensor, a Python int) in one call."""
    def fn(x, idx, k):
        y = torch.softmax(x[idx] * k, dim=-1)
        return (torch.tanh(y) * y).sum()
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(0)) \
        .requires_grad_()
    idx = torch.tensor([0, 2, 2, 5])
    want = torch.autograd.grad(fn(x, idx, 3), x)[0]
    got = torch.autograd.grad(ck.checkpoint_wrapper(fn)(x, idx, 3), x)[0]
    assert torch.equal(want, got)


def test_cpu_checkpointing_holds_a_host_copy_not_the_input():
    """With ``cpu_checkpointing`` the call holds a host copy of its input,
    and nothing of the input itself: it is freed once the caller drops
    it (on the card: ``chip_smoke.check_checkpoint_api`` reads the freed
    bytes)."""
    import gc
    import weakref
    w, x0 = _data(5)
    x = x0 * 1.0                       # a non-leaf: the graph holds none
    ref = weakref.ref(x)
    out = ck.checkpoint_wrapper(_fn, cpu_checkpointing=True)(
        w, x, torch.Generator().manual_seed(0))
    del x
    gc.collect()
    assert ref() is None
    got = torch.autograd.grad(out, x0)[0]
    assert torch.isfinite(got).all() and float(got.abs().max()) > 0
