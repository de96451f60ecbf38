"""The port's hand-written kernels and their wrappers. Every wrapper of the
main path counts its launches (``.launches``; the flash wrappers also by
head width, ``.widths``)."""

from typing import Any, Dict


def kernel_wrappers():
    """Every kernel wrapper of the main path."""
    from mimo_tpu_torch.ops import ffn as FF
    from mimo_tpu_torch.ops import flash_attention as FA
    from mimo_tpu_torch.ops import groupnorm as GN
    from mimo_tpu_torch.ops import rows as R
    from mimo_tpu_torch.ops import temporal_attention as TA
    return (*FA.FLASH_WRAPPERS, GN.group_norm_fused, FF.ln_rows,
            FF.ffn_ln_geglu_fused, FF.qkv_ln_fused, FF.matmul_bias_residual,
            FF.matmul_bias, TA.temporal_attention_ln, TA.temporal_attn_core,
            R.bias_gelu, R.bias_residual)


def launch_counts() -> Dict[str, Any]:
    """The wrappers' launches in this process, and the flash wrappers' by
    head width ([name, d, launches])."""
    from mimo_tpu_torch.ops import flash_attention as FA
    return {"counts": {fn.__name__: fn.launches for fn in kernel_wrappers()},
            "widths": [[fn.__name__, d, n] for fn in FA.FLASH_WRAPPERS
                       for d, n in sorted(fn.widths.items())]}
