"""PyTorch/CUDA port of the Fast-MWEM release system.

A sibling of the JAX package `repro`, laid out the same way so each
module's counterpart is found by name. It imports torch and numpy only.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
every kernel wrapper dispatches on its tensors' device — the hand-written
CUDA kernel for CUDA tensors, the plain PyTorch version for CPU tensors.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
