from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref, make_mask

__all__ = ["attention_ref", "flash_attention", "make_mask"]
