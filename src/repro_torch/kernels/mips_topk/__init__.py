from repro_torch.kernels.mips_topk.ops import MODES, mips_topk
from repro_torch.kernels.mips_topk.ref import mips_topk_ref

__all__ = ["MODES", "mips_topk", "mips_topk_ref"]
