"""Hand-written Hopper kernels of the port and their PyTorch wrappers.

Importing this package builds nothing: ``op_builder`` compiles
``csrc/*.cu`` at the first kernel launch.
"""
from . import flash_attention, fused_elementwise, fused_update, \
    grouped_gemm, paged_attention, sparse_flash

# The kernel wrappers whose ``.launches`` count a run's kernel launches.
KERNEL_WRAPPERS = (fused_elementwise.fused_layer_norm,
                   fused_elementwise.fused_residual_layer_norm,
                   fused_elementwise.fused_bias_gelu,
                   fused_elementwise.layer_norm_backward,
                   fused_elementwise.bias_gelu_backward,
                   fused_update.sqnorm,
                   fused_update.fused_adam_apply,
                   paged_attention.paged_attention,
                   flash_attention.flash_attention_fwd,
                   flash_attention.flash_attention_bwd_dq,
                   flash_attention.flash_attention_bwd_dkv,
                   flash_attention.flash_attention_bwd_fused,
                   sparse_flash.sparse_flash_fwd,
                   sparse_flash.sparse_flash_bwd_dq,
                   sparse_flash.sparse_flash_bwd_dkv,
                   sparse_flash.sparse_flash_bwd_fused,
                   grouped_gemm.grouped_matmul)


def reset_launch_counts() -> None:
    """Zero every wrapper's launch count, and the grouped GEMM's count of
    staged operand copies."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
    grouped_gemm.grouped_matmul.staged = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = ["KERNEL_WRAPPERS", "reset_launch_counts", "launch_counts"]
