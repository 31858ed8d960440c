"""Core mechanisms of the port: accounting, selection, the MWEM driver."""

from repro_torch.core.accountant import (PrivacyLedger, advanced_composition,
                                         calibrate_eps0)
from repro_torch.core.mwem import (MWEMConfig, MWEMResult, MWEMState,
                                   release_cost, run_mwem)
from repro_torch.core.rng import Draws, TorchDraws

__all__ = [
    "Draws", "MWEMConfig", "MWEMResult", "MWEMState", "PrivacyLedger",
    "TorchDraws", "advanced_composition", "calibrate_eps0", "release_cost",
    "run_mwem",
]
