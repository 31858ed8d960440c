"""k-MIPS indices of the port over complement-augmented queries."""

from repro_torch.mips.base import MIPSIndex, augment_complement
from repro_torch.mips.flat import FlatAbsIndex
from repro_torch.mips.ivf import IVFIndex
from repro_torch.mips.marginal import MarginalIVFIndex

__all__ = ["FlatAbsIndex", "IVFIndex", "MIPSIndex", "MarginalIVFIndex",
           "augment_complement"]
