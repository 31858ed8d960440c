from repro_torch.kernels.mwem_step.ops import (CHUNK, MAX_K, MAX_U,
                                               gather_score,
                                               gather_score_batch,
                                               marginal_gather_score,
                                               mwem_step, mwem_step_batch)
from repro_torch.kernels.mwem_step.ref import (UPDATE_RULES,
                                               gather_score_batch_ref,
                                               gather_score_ref,
                                               marginal_gather_score_ref,
                                               mwem_step_batch_ref,
                                               mwem_step_ref, mwu_apply_ref)

__all__ = [
    "CHUNK", "MAX_K", "MAX_U", "UPDATE_RULES", "gather_score",
    "gather_score_batch", "gather_score_batch_ref", "gather_score_ref",
    "marginal_gather_score", "marginal_gather_score_ref", "mwem_step",
    "mwem_step_batch", "mwem_step_batch_ref", "mwem_step_ref",
    "mwu_apply_ref",
]
