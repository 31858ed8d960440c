"""Core mechanisms of the port: accounting, selection, workloads, the
MWEM drivers, the adaptive marginal loop and the private LP solvers."""

from repro_torch.core.accountant import (PrivacyLedger, advanced_composition,
                                         calibrate_eps0)
from repro_torch.core.adaptive import (AdaptiveConfig, AdaptiveResult,
                                       run_adaptive_marginals,
                                       select_worst_marginal)
from repro_torch.core.bregman import bregman_project_dense
from repro_torch.core.lp_dual import (DualLPConfig, DualLPResult,
                                      dual_lp_release_cost, lp_release_cost,
                                      solve_constraint_private_lp)
from repro_torch.core.lp_scalar import (LPPendingBatch, ScalarLPBatchResult,
                                        ScalarLPConfig, ScalarLPResult,
                                        finish_lp_batch, launch_lp_batch,
                                        scalar_lp_release_cost, solve_lp_batch,
                                        solve_scalar_lp)
from repro_torch.core.mwem import (MWEMBatchResult, MWEMConfig,
                                   MWEMPendingBatch, MWEMResult, MWEMState,
                                   finish_mwem_batch, launch_mwem_batch,
                                   release_cost, run_mwem, run_mwem_batch)
from repro_torch.core.rng import Draws, LaneDraws, TorchDraws
from repro_torch.core.workload import (DenseWorkload, MarginalWorkload,
                                       as_workload, aug_decompose)

__all__ = [
    "AdaptiveConfig", "AdaptiveResult", "DenseWorkload", "Draws",
    "DualLPConfig", "DualLPResult", "LPPendingBatch", "LaneDraws",
    "MWEMBatchResult", "MWEMConfig", "MWEMPendingBatch", "MWEMResult",
    "MWEMState", "MarginalWorkload", "PrivacyLedger", "ScalarLPBatchResult",
    "ScalarLPConfig", "ScalarLPResult", "TorchDraws", "advanced_composition",
    "as_workload", "aug_decompose", "bregman_project_dense", "calibrate_eps0",
    "dual_lp_release_cost", "finish_lp_batch", "finish_mwem_batch",
    "launch_lp_batch", "launch_mwem_batch", "lp_release_cost", "release_cost",
    "run_adaptive_marginals", "run_mwem", "run_mwem_batch",
    "scalar_lp_release_cost", "select_worst_marginal",
    "solve_constraint_private_lp", "solve_lp_batch", "solve_scalar_lp",
]
