"""Launcher constants (the port's copy of
``deepspeed_tpu/launcher/constants.py``, with the reference's CUDA-side
export list)."""

PDSH_LAUNCHER = "pdsh"
SSH_LAUNCHER = "ssh"
# The JAX package's Cloud TPU pod dispatch: no NVIDIA counterpart, refused
# (ROADMAP queue 1 item 8).
GCLOUD_LAUNCHER = "gcloud"

DEFAULT_HOSTFILE = "/job/hostfile"
DEFAULT_MASTER_PORT = 29500

# Variables forwarded to the other nodes when set here (reference
# launcher/constants.py: the NCCL, PYTHON and CUDA prefixes).
EXPORT_ENV_PREFIXES = ["NCCL", "PYTHON", "CUDA", "TORCH", "DS_"]

# A `.deepspeed_env` file in ~ or . adds KEY=VALUE exports for all nodes
# (reference runner.py:27-28).
DEEPSPEED_ENVIRONMENT_NAME = ".deepspeed_env"
