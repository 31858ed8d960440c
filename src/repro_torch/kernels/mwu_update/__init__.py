from repro_torch.kernels.mwu_update.ops import mwu_update, plan
from repro_torch.kernels.mwu_update.ref import mwu_update_ref

__all__ = ["mwu_update", "mwu_update_ref", "plan"]
