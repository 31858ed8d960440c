"""k-MIPS indices of the port: over complement-augmented queries (the
release paths) and over arbitrary rows (the LP solvers)."""

from repro_torch.mips.base import MIPSIndex, augment_complement
from repro_torch.mips.flat import FlatAbsIndex, FlatIndex
from repro_torch.mips.ivf import IVFIndex
from repro_torch.mips.marginal import MarginalIVFIndex
from repro_torch.mips.transform import (lp_dual_rows, lp_scalar_rows,
                                        mips_to_knn_keys, mips_to_knn_query)

__all__ = ["FlatAbsIndex", "FlatIndex", "IVFIndex", "MIPSIndex",
           "MarginalIVFIndex", "augment_complement", "lp_dual_rows",
           "lp_scalar_rows", "mips_to_knn_keys", "mips_to_knn_query"]
