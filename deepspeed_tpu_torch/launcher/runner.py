"""The ``deepspeed`` front end for CUDA nodes (port of
``deepspeed_tpu/launcher/runner.py``).

The reference's process model: one worker process per card slot (times
``--procs_per_node``, which puts several ranks on one slot: the CPU tests
and a one-card machine). The runner reads the resource pool, filters it
(``--include`` / ``--exclude``, ``--num_nodes``, ``--num_gpus``), encodes
the world info, and starts ``launcher/launch.py`` on every node: locally
on one node, through a multi-node runner (``pdsh`` or ``ssh``) on several.

Resource pool, in priority order:
1. ``--hostfile`` in MPI style (``worker-0 slots=8``), the reference's
   format;
2. this host alone, with ``--num_gpus`` slots, else
   ``torch.cuda.device_count()`` (one without a card).

The JAX package's ``--tpu_pod`` discovery and its ``gcloud`` launcher
address Cloud TPU VMs and have no NVIDIA counterpart (ROADMAP queue 1 item
8, not planned): ``--launcher gcloud`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import base64
import collections
import json
import os
import subprocess
import sys
from copy import deepcopy
from typing import Dict, List, Optional

from .constants import (DEEPSPEED_ENVIRONMENT_NAME, DEFAULT_HOSTFILE,
                        DEFAULT_MASTER_PORT, EXPORT_ENV_PREFIXES,
                        GCLOUD_LAUNCHER, PDSH_LAUNCHER, SSH_LAUNCHER)
from ..utils.logging import logger

# The checkout that holds this package: put on the workers' PYTHONPATH.
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GCLOUD_NOT_PLANNED = (
    "--launcher gcloud dispatches onto Cloud TPU VMs, which have no NVIDIA "
    "counterpart: not planned for the port (ROADMAP queue 1 item 8, the "
    "not-planned gcloud / TPU-pod entry); use pdsh or ssh")


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        description="deepspeed_tpu_torch runner: launch training on one or "
                    "more CUDA nodes")
    parser.add_argument("-H", "--hostfile", type=str, default=DEFAULT_HOSTFILE,
                        help="MPI-style hostfile: '<host> slots=<cards>' per "
                             "line")
    parser.add_argument("-i", "--include", type=str, default="",
                        help="NODE_SPEC[@NODE_SPEC ...] with "
                             "NODE_SPEC=NAME[:SLOT[,SLOT ...]]")
    parser.add_argument("-e", "--exclude", type=str, default="",
                        help="same syntax as --include; mutually exclusive")
    parser.add_argument("--num_nodes", type=int, default=-1,
                        help="use only the first N hosts of the pool")
    parser.add_argument("--num_gpus", "--num_chips", dest="num_gpus",
                        type=int, default=-1,
                        help="use cards [0:N) on every host")
    parser.add_argument("--master_port", "--coordinator_port",
                        dest="master_port", type=int,
                        default=DEFAULT_MASTER_PORT)
    parser.add_argument("--master_addr", "--coordinator_addr",
                        dest="master_addr", type=str, default="")
    parser.add_argument("--launcher", type=str, default=PDSH_LAUNCHER,
                        help=f"{PDSH_LAUNCHER} | {SSH_LAUNCHER}")
    parser.add_argument("--launcher_args", type=str, default="")
    parser.add_argument("--procs_per_node", type=int, default=1,
                        help="worker processes per card slot (1 on a "
                             "machine with a card per rank; more put "
                             "several ranks on one slot)")
    parser.add_argument("--force_multi", action="store_true",
                        help="treat a 1-host pool as multi-node (ssh path)")
    parser.add_argument("user_script", type=str)
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path: str) -> Optional["collections.OrderedDict"]:
    """Parse ``<host> slots=<n>`` lines (reference runner.py:115-142)."""
    if not os.path.isfile(hostfile_path):
        logger.warning("Unable to find hostfile, proceeding with local "
                       "resources only.")
        return None
    resource_pool: "collections.OrderedDict[str, int]" = collections.OrderedDict()
    with open(hostfile_path) as fd:
        for line in fd:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                _, slot_count = slots.split("=")
                slot_count = int(slot_count)
            except ValueError as err:
                logger.error("Hostfile is not formatted correctly")
                raise err
            if hostname in resource_pool:
                raise ValueError(f"host {hostname} is already defined")
            resource_pool[hostname] = slot_count
    return resource_pool


def parse_resource_filter(host_info: Dict[str, List[int]], include_str="",
                          exclude_str="") -> "collections.OrderedDict":
    """Filter ``{host: [slot, ...]}`` by NODE_SPEC strings (reference
    runner.py:146-231): ``worker-0@worker-1:0,2`` keeps all of worker-0
    and slots 0 and 2 of worker-1; an exclusion removes the listed slots
    (a bare hostname the whole host). Include and exclude are mutually
    exclusive."""
    NODE_SEP, SLOT_LIST_START, SLOT_SEP = "@", ":", ","

    if include_str and exclude_str:
        raise ValueError("include_str and exclude_str are mutually exclusive.")
    if not include_str and not exclude_str:
        return collections.OrderedDict(host_info)

    filtered_hosts: Dict[str, List[int]] = {}
    if include_str:
        parse_str = include_str
    else:
        filtered_hosts = deepcopy(dict(host_info))
        parse_str = exclude_str

    for node_config in parse_str.split(NODE_SEP):
        if SLOT_LIST_START in node_config:
            hostname, slots = node_config.split(SLOT_LIST_START)
            slot_ids = [int(x) for x in slots.split(SLOT_SEP)]
            if hostname not in host_info:
                raise ValueError(f"Hostname '{hostname}' not found in hostfile")
            for s in slot_ids:
                if s not in host_info[hostname]:
                    raise ValueError(
                        f"No slot '{s}' specified on host '{hostname}'")
            if include_str:
                filtered_hosts[hostname] = slot_ids
            else:
                for s in slot_ids:
                    filtered_hosts[hostname].remove(s)
        else:
            hostname = node_config
            if hostname not in host_info:
                raise ValueError(f"Hostname '{hostname}' not found in hostfile")
            if include_str:
                filtered_hosts[hostname] = list(host_info[hostname])
            else:
                filtered_hosts[hostname] = []

    # dedup slots, drop empty hosts, restore hostfile ordering
    ordered = collections.OrderedDict()
    for host in host_info:
        if host in filtered_hosts and filtered_hosts[host]:
            ordered[host] = sorted(set(filtered_hosts[host]))
    return ordered


def parse_inclusion_exclusion(resource_pool: Dict[str, int], inclusion: str,
                              exclusion: str) -> "collections.OrderedDict":
    active = collections.OrderedDict(
        (host, list(range(slots))) for host, slots in resource_pool.items())
    return parse_resource_filter(active, include_str=inclusion,
                                 exclude_str=exclusion)


def encode_world_info(world_info: Dict[str, List[int]]) -> str:
    return base64.urlsafe_b64encode(
        json.dumps(world_info).encode("utf-8")).decode("utf-8")


def decode_world_info(world_info_base64: str) -> Dict[str, List[int]]:
    return json.loads(base64.urlsafe_b64decode(world_info_base64))


def _local_slots() -> int:
    """This host's card count (one slot without a card, for the CPU)."""
    import torch
    return max(1, torch.cuda.device_count())


def _resolve_master(active_resources, args) -> str:
    if args.master_addr:
        return args.master_addr
    first_host = next(iter(active_resources))
    if first_host in ("localhost", "127.0.0.1"):
        return "127.0.0.1"
    out = subprocess.check_output(["ssh", first_host, "hostname", "-I"])
    addr = out.decode("utf-8").split()[0]
    logger.info(f"Using IP address of {addr} for node {first_host}")
    return addr


def _collect_exports(env) -> Dict[str, str]:
    exports = {}
    for var, val in env.items():
        if any(var.startswith(p) for p in EXPORT_ENV_PREFIXES):
            exports[var] = val
    for environ_path in [os.path.expanduser("~"), "."]:
        environ_file = os.path.join(environ_path, DEEPSPEED_ENVIRONMENT_NAME)
        if os.path.isfile(environ_file):
            with open(environ_file) as fd:
                for line in fd:
                    line = line.strip()
                    if line and "=" in line:
                        key, val = line.split("=", 1)
                        exports[key] = val
    return exports


def main(args=None) -> int:
    args = parse_args(args)
    launcher = args.launcher.lower()
    if launcher == GCLOUD_LAUNCHER:
        raise NotImplementedError(GCLOUD_NOT_PLANNED)

    if (args.num_nodes >= 0 or args.num_gpus >= 0) and \
            (args.include or args.exclude):
        raise ValueError("Cannot specify num_nodes/gpus with include/exclude")

    resource_pool = fetch_hostfile(args.hostfile)
    multi_node_exec = bool(resource_pool)
    if not resource_pool:
        resource_pool = collections.OrderedDict(
            localhost=args.num_gpus if args.num_gpus > 0
            else _local_slots())
        args.master_addr = args.master_addr or "127.0.0.1"
        multi_node_exec = False

    if not multi_node_exec and args.num_nodes > 1:
        raise ValueError("num_nodes > 1 but no extra nodes via hostfile")

    active_resources = parse_inclusion_exclusion(resource_pool, args.include,
                                                 args.exclude)
    if args.num_nodes > 0:
        active_resources = collections.OrderedDict(
            list(active_resources.items())[:args.num_nodes])
    if args.num_gpus > 0:
        active_resources = collections.OrderedDict(
            (h, list(range(args.num_gpus))) for h in active_resources)

    env = os.environ.copy()
    env["PYTHONPATH"] = PACKAGE_ROOT + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    master = _resolve_master(active_resources, args)
    world_info_base64 = encode_world_info(active_resources)
    multi_node_exec = args.force_multi or len(active_resources) > 1

    if not multi_node_exec:
        cmd = [sys.executable, "-u", "-m",
               "deepspeed_tpu_torch.launcher.launch",
               f"--world_info={world_info_base64}",
               f"--master_addr={master}",
               f"--master_port={args.master_port}",
               f"--procs_per_node={args.procs_per_node}",
               "--node_rank=0",
               args.user_script] + args.user_args
    else:
        from .multinode_runner import PDSHRunner, SSHRunner
        if launcher == PDSH_LAUNCHER:
            runner = PDSHRunner(args, world_info_base64)
        elif launcher == SSH_LAUNCHER:
            runner = SSHRunner(args, world_info_base64)
        else:
            raise NotImplementedError(f"Unknown launcher {args.launcher}")
        if not runner.backend_exists():
            raise RuntimeError(f"launcher '{args.launcher}' not installed")
        for key, val in _collect_exports(env).items():
            runner.add_export(key, val)
        cmd = runner.get_cmd(env, active_resources, master)

    logger.info(f"cmd = {' '.join(cmd)}")
    result = subprocess.Popen(cmd, env=env)
    result.wait()
    return result.returncode


if __name__ == "__main__":
    sys.exit(main())
