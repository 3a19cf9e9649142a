"""The port's pipeline schedules (``runtime/pipe/schedule.py``) against
the JAX package's: the instruction lists of ``TrainSchedule``,
``InferenceSchedule`` and ``DataParallelSchedule``, their buffer counts
and ``train_schedule_events``, for M 1-8 micro-batches over P 1-4
stages. Then the port's interpreter (``interpret``) runs every stage's
``TrainSchedule`` in a thread of its own, with blocking receives and
sends that never block: every send meets its receive, in order, no
stage waits forever, and a buffer is never overwritten while live.
Pure Python: no process group, no JAX arrays."""
import queue
import threading

import pytest

from deepspeed_tpu.runtime.pipe import schedule as jsched

from deepspeed_tpu_torch.runtime.pipe import schedule as tsched

GRID = [(m, p) for m in range(1, 9) for p in range(1, 5)]


def _as_tuples(prog):
    return [[(type(c).__name__, c.kwargs) for c in step] for step in prog]


@pytest.mark.parametrize("m, p", GRID)
def test_instruction_lists_equal_jax(m, p):
    for name in ("TrainSchedule", "InferenceSchedule",
                 "DataParallelSchedule"):
        for s in range(p):
            if name == "DataParallelSchedule" and s:
                continue
            js = getattr(jsched, name)(micro_batches=m, stages=p, stage_id=s)
            ts = getattr(tsched, name)(micro_batches=m, stages=p, stage_id=s)
            assert _as_tuples(ts.steps()) == _as_tuples(js.steps()), \
                (name, m, p, s)
            assert ts.num_pipe_buffers() == js.num_pipe_buffers()
    assert tsched.train_schedule_events(m, p) == \
        jsched.train_schedule_events(m, p)


@pytest.mark.parametrize("m, p", [(1, 2), (4, 2), (8, 4), (3, 4), (8, 3)])
def test_threaded_interpreter_pairs_every_send(m, p):
    """Each stage a thread; activations and grads on FIFO queues between
    neighbours. A receive blocks (with a timeout: a deadlock fails the
    test), a send never does, as the engine's isend."""
    acts = [queue.Queue() for _ in range(p + 1)]     # into stage s
    grads = [queue.Queue() for _ in range(p + 1)]    # into stage s
    errors, counts = [], [None] * p

    def stage(s):
        sched = tsched.TrainSchedule(micro_batches=m, stages=p, stage_id=s)
        live, bufs = {}, {}
        n = {"load": 0, "fwd": 0, "bwd": 0, "sent": 0, "max_live": 0}

        def get(q):
            return q.get(timeout=10)

        def load(c):
            bufs[c.buffer_id] = ("x", n["load"])
            n["load"] += 1

        def recv_act(c):
            assert c.buffer_id not in live, "overwrote a live buffer"
            bufs[c.buffer_id] = get(acts[s])

        def forward(c):
            kind, micro = bufs[c.buffer_id]
            assert micro == n["fwd"], (micro, n)
            n["fwd"] += 1
            live[c.buffer_id] = micro
            n["max_live"] = max(n["max_live"], len(live))

        def send_act(c):
            acts[s + 1].put(("x", live[c.buffer_id]))
            n["sent"] += 1

        def recv_grad(c):
            kind, micro = get(grads[s])
            assert micro == live[c.buffer_id]

        def backward(c):
            micro = live.pop(c.buffer_id)
            assert micro == n["bwd"], (micro, n)
            n["bwd"] += 1
            bufs[c.buffer_id] = ("g", micro)

        def send_grad(c):
            grads[s - 1].put(bufs[c.buffer_id])
            n["sent"] += 1

        def nothing(c):
            return None
        try:
            steps = tsched.interpret(sched, {
                tsched.LoadMicroBatch: load,
                tsched.RecvActivation: recv_act,
                tsched.ForwardPass: forward,
                tsched.SendActivation: send_act,
                tsched.RecvGrad: recv_grad,
                tsched.BackwardPass: backward,
                tsched.SendGrad: send_grad,
                tsched.ReduceTiedGrads: nothing,
                tsched.ReduceGrads: nothing,
                tsched.OptimizerStep: nothing})
            counts[s] = dict(n, steps=steps)
        except Exception as e:          # noqa: BLE001 (reported below)
            errors.append((s, repr(e)))

    threads = [threading.Thread(target=stage, args=(s,)) for s in range(p)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for s, c in enumerate(counts):
        assert c["fwd"] == c["bwd"] == m
        assert c["load"] == (m if s == 0 else 0)
        # every activation and grad sent was received
        assert c["sent"] == (s < p - 1) * m + (s > 0) * m
        assert c["max_live"] <= tsched.TrainSchedule(
            micro_batches=m, stages=p, stage_id=s).num_pipe_buffers()
        assert c["steps"] == 2 * (m + p - 1)
    assert all(q.empty() for q in acts + grads)


def test_interpret_refuses_an_unhandled_instruction():
    sched = tsched.InferenceSchedule(micro_batches=2, stages=1, stage_id=0)
    with pytest.raises(TypeError, match="no handler"):
        tsched.interpret(sched, {tsched.LoadMicroBatch: lambda c: None})
