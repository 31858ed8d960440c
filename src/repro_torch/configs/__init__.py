"""Architecture registry of the port, counterpart of `repro.configs`.

``get_config(name)`` returns the published configuration and
``get_smoke_config(name)`` a reduced one of the same family for CPU tests.
Only the architectures whose blocks the port runs are listed; any other
name of the reference's zoo raises, saying it is not ported yet.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, uniform_stages

ARCH_MODULES = {
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}
ARCH_NAMES = tuple(ARCH_MODULES)
# the reference's other architectures, which need blocks not ported yet
# (MoE, ring-buffer attention, RG-LRU, encoder-decoder, mrope)
NOT_PORTED = ("minitron-8b", "nemotron-4-340b", "llama3-8b",
              "llama4-scout-17b-a16e", "qwen3-moe-30b-a3b",
              "recurrentgemma-2b", "qwen2-vl-72b", "whisper-large-v3")


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: "
            f"{ARCH_NAMES}")
    if name not in ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; options: {ARCH_NAMES}")
    return importlib.import_module(ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ModelConfig", "uniform_stages", "ARCH_NAMES", "get_config",
           "get_smoke_config"]
