"""The port's serving engine under tensor parallelism (mp 2: each rank
its heads' K/V pools and its parts of the weights) and sequence
parallelism (sp 2: the whole-prompt prefill through the ring) against
JAX's ``InferenceEngine`` on the same mesh, on gpt2-tiny in fp32 with
the weights of tests/test_torch_serving.py.

The port runs two gloo processes of ``tests/torch_dp_worker.py``
(``serve`` jobs, both ranks stepping the same scheduler); the JAX
engine runs in this process on ``build_mesh(mp=2 | sp=2,
devices=jax.devices()[:2])`` with ``paged_kernel: false`` (ROADMAP R2).
Prefill and decode logits agree within 1e-4 (as JAX's
``TestTensorParallelServing`` holds its engine); greedy streams through
``serve()`` are equal; both ranks return the same, at temperature 0.8
too (each rank's generator draws in step).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.inference import scheduler as jsched
from deepspeed_tpu.models.gpt2 import gpt2_param_shardings as jshardings
from deepspeed_tpu.parallel.topology import build_mesh

import torch_dp_worker as W
from test_torch_dp import load, save_params, wait
from test_torch_serving import ATOL, INF, JCFG, _drive, _params_np

# name: (mesh, inference block)
CASES = {
    "mp2": ({"mp": 2}, dict(INF)),
    "sp2": ({"sp": 2}, dict(INF, prefill_chunk=0)),
}


def jax_serve(params, mesh, inf):
    eng = JEngine(JCFG, jax.tree_util.tree_map(jnp.asarray, params),
                  config={"inference": dict(inf, paged_kernel=False)},
                  mesh=build_mesh(mp=mesh.get("mp", 1),
                                  sp=mesh.get("sp", 1),
                                  devices=jax.devices()[:2]),
                  param_shardings=jshardings(JCFG))
    logits, toks = _drive(eng)
    for s in (0, 1):
        eng.release_slot(s)
    eng.reset_serving_stats()
    rep = eng.serve(jsched.synthetic_requests(
        6, prompt_len=(5, 20), max_new_tokens=6, vocab_size=512, seed=1))
    eng.close()
    return logits, toks, [r["tokens"] for r in rep["requests"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpserve"))
    params = _params_np()
    pp = os.path.join(d, "p.npz")
    save_params(params, pp)
    jobs = [dict(name=n, serve=inf, mesh=mesh, out=os.path.join(d, n))
            for n, (mesh, inf) in CASES.items()]
    procs = W.spawn_forked(d, 2, jobs, "w2", pp)
    jax_out = {n: jax_serve(params, mesh, inf)
               for n, (mesh, inf) in CASES.items()}
    wait(procs)
    return {n: load(os.path.join(d, n), 2) for n in CASES}, jax_out


@pytest.mark.parametrize("name", list(CASES))
def test_step_logits_match_jax(runs, name):
    port, jax_out = runs
    jlogits, jtoks, _ = jax_out[name]
    for r in port[name]:
        for i, want in enumerate(jlogits):
            want = np.asarray(want).reshape(-1, want.shape[-1])
            got = r["logits"][2 * i:2 * i + len(want)]
            np.testing.assert_allclose(got, want, atol=ATOL,
                                       err_msg=f"step {i}")
        np.testing.assert_array_equal(
            [t[0] for t in r["toks"][:2]], jtoks[:2])
        np.testing.assert_array_equal(r["toks"][2:], jtoks[2:])


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_streams_match_jax(runs, name):
    port, jax_out = runs
    want = jax_out[name][2]
    for r in port[name]:
        got = [[int(t) for t in row if t >= 0] for row in r["streams"][:6]]
        assert got == [list(map(int, w)) for w in want]
        np.testing.assert_array_equal(r["streams"], port[name][0]["streams"])
