"""Multi-node backends: the command that starts ``launch.py`` on every
node (port of ``deepspeed_tpu/launcher/multinode_runner.py``; reference
launcher/multinode_runner.py: PDSH, and a plain-ssh fan-out). The JAX
package's ``GcloudTPURunner`` dispatches onto Cloud TPU VMs and is not
planned here (``runner.GCLOUD_NOT_PLANNED``).
"""
from __future__ import annotations

import os
import shlex
import shutil
import sys
from abc import ABC, abstractmethod
from typing import Dict, List


class MultiNodeRunner(ABC):
    def __init__(self, args, world_info_base64: str):
        self.args = args
        self.user_arguments = list(args.user_args)
        self.user_script = args.user_script
        self.world_info_base64 = world_info_base64
        self.exports: Dict[str, str] = {}

    @abstractmethod
    def backend_exists(self) -> bool:
        ...

    @abstractmethod
    def get_cmd(self, environment, active_resources, master) -> List[str]:
        ...

    def add_export(self, key: str, var: str) -> None:
        self.exports[key.strip()] = var.strip()

    def _launch_cmd(self, master: str, node_rank_flag: str) -> List[str]:
        return [
            sys.executable, "-u", "-m", "deepspeed_tpu_torch.launcher.launch",
            f"--world_info={self.world_info_base64}",
            f"--master_addr={master}",
            f"--master_port={self.args.master_port}",
            f"--procs_per_node={self.args.procs_per_node}",
            node_rank_flag,
            self.user_script,
        ] + self.user_arguments

    def _remote_shell_cmd(self, master: str, node_rank_flag: str) -> str:
        """The remote shell line every backend runs: the exports, cd into
        the launch directory, then launch.py."""
        exports = "".join(f"export {key}={shlex.quote(val)}; "
                          for key, val in self.exports.items())
        return exports + f"cd {os.path.abspath('.')}; " + \
            " ".join(self._launch_cmd(master, node_rank_flag))


class PDSHRunner(MultiNodeRunner):
    """Fan out over pdsh; each node finds its rank by its hostname."""

    def backend_exists(self) -> bool:
        return shutil.which("pdsh") is not None

    def get_cmd(self, environment, active_resources, master) -> List[str]:
        environment["PDSH_RCMD_TYPE"] = "ssh"
        active_workers = ",".join(active_resources.keys())
        # -S: pdsh exits with the largest remote exit code (without it a
        # dead worker looks like success).
        return [
            "pdsh", "-S", "-f", "1024", "-w", active_workers,
        ] + (self.args.launcher_args.split() if self.args.launcher_args
             else []) + [
            self._remote_shell_cmd(master, "--node_rank=-1")
        ]


class SSHRunner(MultiNodeRunner):
    """One ssh per node, all started by one shell; the rank passed
    explicitly."""

    def backend_exists(self) -> bool:
        return shutil.which("ssh") is not None

    def get_cmd(self, environment, active_resources, master) -> List[str]:
        cmds = []
        for rank, host in enumerate(active_resources.keys()):
            remote = self._remote_shell_cmd(master, f"--node_rank={rank}")
            cmds.append(f"ssh {host} {shlex.quote(remote)}")
        # Wait for each; exit non-zero if ANY node failed (a plain `wait`
        # returns 0 and hides a dead job).
        script = (" pids=(); " +
                  " ".join(f"{c} & pids+=($!);" for c in cmds) +
                  " rc=0; for p in \"${pids[@]}\"; do"
                  " wait \"$p\" || rc=$?; done; exit $rc")
        return ["/bin/bash", "-c", script]
