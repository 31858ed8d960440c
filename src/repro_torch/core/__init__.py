"""Core mechanisms of the port: accounting, selection, the MWEM drivers."""

from repro_torch.core.accountant import (PrivacyLedger, advanced_composition,
                                         calibrate_eps0)
from repro_torch.core.mwem import (MWEMBatchResult, MWEMConfig,
                                   MWEMPendingBatch, MWEMResult, MWEMState,
                                   finish_mwem_batch, launch_mwem_batch,
                                   release_cost, run_mwem, run_mwem_batch)
from repro_torch.core.rng import Draws, LaneDraws, TorchDraws

__all__ = [
    "Draws", "LaneDraws", "MWEMBatchResult", "MWEMConfig", "MWEMPendingBatch",
    "MWEMResult", "MWEMState", "PrivacyLedger", "TorchDraws",
    "advanced_composition", "calibrate_eps0", "finish_mwem_batch",
    "launch_mwem_batch", "release_cost", "run_mwem", "run_mwem_batch",
]
