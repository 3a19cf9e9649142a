"""Per-node launcher: start and supervise this node's worker processes
(port of ``deepspeed_tpu/launcher/launch.py``, with the reference's CUDA
process model).

One process per card slot of this node, times ``--procs_per_node``. Each
gets the environment ``parallel/comm.init_distributed`` reads:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
(the process's index on this node), and ``CUDA_VISIBLE_DEVICES`` naming
the node's slots (every process sees them all and takes ``cuda:LOCAL_RANK
% device_count``), and the argument ``--local_rank=<n>``. A child that
exits non-zero, or a SIGINT/SIGTERM to this process, kills every child of
the node, and the launch exits non-zero (the JAX package's supervision,
reference launch.py:151-167).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List

from .runner import decode_world_info
from ..utils.logging import logger


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="per-node process launcher for deepspeed_tpu_torch")
    parser.add_argument("--world_info", type=str, required=True,
                        help="base64 {host: [slot,...]} map from the runner")
    parser.add_argument("--node_rank", type=int, default=-1,
                        help="this host's index; defaults to matching "
                             "hostname against world_info keys")
    parser.add_argument("--master_addr", type=str, default="127.0.0.1")
    parser.add_argument("--master_port", type=int, default=29500)
    parser.add_argument("--procs_per_node", type=int, default=1,
                        help="processes per card slot")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def _infer_node_rank(world: dict) -> int:
    import socket
    hostname = socket.gethostname()
    hosts = list(world.keys())
    for cand in (hostname, hostname.split(".")[0], "localhost"):
        if cand in hosts:
            return hosts.index(cand)
    raise ValueError(f"host {hostname} not found in world info {hosts}")


def node_processes(world: dict, ppn: int) -> List[int]:
    """Worker processes of each node, in world-info order: its slots
    times ``ppn``."""
    return [len(slots) * ppn for slots in world.values()]


def worker_env(base: dict, world: dict, node_rank: int, local_rank: int,
               ppn: int, master_addr: str, master_port: int) -> dict:
    """The environment of one worker process."""
    per_node = node_processes(world, ppn)
    slots = list(world.values())[node_rank]
    env = dict(base)
    env["MASTER_ADDR"] = master_addr
    env["MASTER_PORT"] = str(master_port)
    env["WORLD_SIZE"] = str(sum(per_node))
    env["RANK"] = str(sum(per_node[:node_rank]) + local_rank)
    env["LOCAL_RANK"] = str(local_rank)
    env["CUDA_VISIBLE_DEVICES"] = ",".join(str(s) for s in slots)
    return env


def main(args=None) -> int:
    args = parse_args(args)
    world = decode_world_info(args.world_info)
    node_rank = args.node_rank if args.node_rank >= 0 else \
        _infer_node_rank(world)
    hosts = list(world.keys())
    if not 0 <= node_rank < len(hosts):
        raise ValueError(f"node_rank {node_rank} out of range for "
                         f"{len(hosts)} hosts")
    ppn = max(1, args.procs_per_node)

    processes: List[subprocess.Popen] = []

    def sigkill_handler(signum=None, frame=None):
        for p in processes:
            if p.poll() is None:
                logger.info(f"Killing subprocess {p.pid}")
                try:
                    p.kill()
                except OSError:
                    pass
        if signum is not None:
            sys.exit(128 + signum)

    signal.signal(signal.SIGINT, sigkill_handler)
    signal.signal(signal.SIGTERM, sigkill_handler)

    for local_rank in range(node_processes(world, ppn)[node_rank]):
        env = worker_env(os.environ, world, node_rank, local_rank, ppn,
                         args.master_addr, args.master_port)
        cmd = [sys.executable, "-u", args.user_script,
               f"--local_rank={local_rank}"] + args.user_args
        logger.info(f"launching rank {env['RANK']}: {' '.join(cmd)}")
        processes.append(subprocess.Popen(cmd, env=env))

    # Supervise: any child failing kills the whole node's processes.
    alive = list(processes)
    rc = 0
    try:
        while alive:
            finished = [p for p in alive if p.poll() is not None]
            for p in finished:
                alive.remove(p)
                if p.returncode != 0:
                    logger.error(f"process {p.pid} exited with "
                                 f"code {p.returncode}; killing node")
                    rc = p.returncode
                    sigkill_handler()
                    alive = []
                    break
            time.sleep(0.1)
    finally:
        sigkill_handler()
    return rc


if __name__ == "__main__":
    sys.exit(main())
