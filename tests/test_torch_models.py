"""The port's GPT-2 model (deepspeed_tpu_torch/models) against the JAX
package's: the parameter converter round trip is exact, and the plain
full-sequence forward matches JAX ``gpt2_apply`` on gpt2-tiny in fp32
(atol 1e-4 on logits; 1e-5 with ``gelu_exact``, the erf form of GELU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.gpt2 import GPT2_CONFIGS as JCONFIGS
from deepspeed_tpu.models.gpt2 import gpt2_apply as jgpt2_apply
from deepspeed_tpu.models.gpt2 import gpt2_init as jgpt2_init
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, gpt2_apply, \
    gpt2_init

JCFG = dataclasses.replace(JCONFIGS["gpt2-tiny"], dtype=jnp.float32)
TCFG = dataclasses.replace(GPT2_CONFIGS["gpt2-tiny"], dtype=torch.float32)


@pytest.fixture(scope="module")
def jax_params_np():
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt2_init(jax.random.PRNGKey(0), JCFG))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_configs_mirror_jax():
    for name, jc in JCONFIGS.items():
        tc = GPT2_CONFIGS[name]
        for f in ("hidden_size", "num_heads", "num_layers", "ffn_size",
                  "max_seq_length", "vocab_size", "layer_norm_eps",
                  "initializer_range", "head_dim", "name"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)


def test_init_tree_matches_jax(jax_params_np):
    tp = gpt2_init(TCFG, torch.Generator().manual_seed(0), "cpu")
    jf, tf = _flat(jax_params_np), _flat(tp)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(tf[k].shape) == jf[k].shape, k
        assert tf[k].dtype == torch.float32


def test_convert_round_trip_is_exact(jax_params_np):
    state = convert.from_jax_params(jax_params_np)
    back = convert.to_jax_params(state)
    jf, bf = _flat(jax_params_np), _flat(back)
    assert sorted(jf) == sorted(bf)
    for k in jf:
        assert bf[k].dtype == jf[k].dtype and bf[k].shape == jf[k].shape
        np.testing.assert_array_equal(bf[k], jf[k])
    # and the torch side carries the same bits
    np.testing.assert_array_equal(state["blocks"]["qkv_kernel"].numpy(),
                                  jax_params_np["blocks"]["qkv_kernel"])


def _apply_both(jax_params_np, jcfg, tcfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    ref = np.asarray(jgpt2_apply(
        jax.tree_util.tree_map(jnp.asarray, jax_params_np),
        jnp.asarray(tokens), jcfg))
    out = gpt2_apply(convert.from_jax_params(jax_params_np),
                     torch.from_numpy(tokens).long(), tcfg)
    assert out.shape == ref.shape and out.dtype == torch.float32
    return out.numpy(), ref


def test_gpt2_apply_matches_jax_fp32(jax_params_np):
    out, ref = _apply_both(jax_params_np, JCFG, TCFG)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_gpt2_apply_matches_jax_fp32_gelu_exact(jax_params_np):
    """The erf form on both sides within 1e-5 (the tanh form in the port
    against the erf form in JAX reads 4.7e-5 apart)."""
    out, ref = _apply_both(
        jax_params_np, dataclasses.replace(JCFG, gelu_exact=True),
        dataclasses.replace(TCFG, gelu_exact=True))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_gpt2_init_requires_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt2_init(TCFG)
