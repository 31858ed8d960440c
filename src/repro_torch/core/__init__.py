"""Core mechanisms of the port: accounting, selection, workloads, the
MWEM drivers and the adaptive marginal loop."""

from repro_torch.core.accountant import (PrivacyLedger, advanced_composition,
                                         calibrate_eps0)
from repro_torch.core.adaptive import (AdaptiveConfig, AdaptiveResult,
                                       run_adaptive_marginals,
                                       select_worst_marginal)
from repro_torch.core.mwem import (MWEMBatchResult, MWEMConfig,
                                   MWEMPendingBatch, MWEMResult, MWEMState,
                                   finish_mwem_batch, launch_mwem_batch,
                                   release_cost, run_mwem, run_mwem_batch)
from repro_torch.core.rng import Draws, LaneDraws, TorchDraws
from repro_torch.core.workload import (DenseWorkload, MarginalWorkload,
                                       as_workload, aug_decompose)

__all__ = [
    "AdaptiveConfig", "AdaptiveResult", "DenseWorkload", "Draws",
    "LaneDraws", "MWEMBatchResult", "MWEMConfig", "MWEMPendingBatch",
    "MWEMResult", "MWEMState", "MarginalWorkload", "PrivacyLedger",
    "TorchDraws", "advanced_composition", "as_workload", "aug_decompose",
    "calibrate_eps0", "finish_mwem_batch", "launch_mwem_batch",
    "release_cost", "run_adaptive_marginals", "run_mwem", "run_mwem_batch",
    "select_worst_marginal",
]
