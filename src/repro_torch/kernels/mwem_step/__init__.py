from repro_torch.kernels.mwem_step.ops import (MAX_U, gather_score,
                                               mwem_step)
from repro_torch.kernels.mwem_step.ref import (UPDATE_RULES,
                                               gather_score_ref,
                                               mwem_step_ref, mwu_apply_ref)

__all__ = [
    "MAX_U", "UPDATE_RULES", "gather_score", "gather_score_ref", "mwem_step",
    "mwem_step_ref", "mwu_apply_ref",
]
