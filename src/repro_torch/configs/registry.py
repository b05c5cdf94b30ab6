"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

from repro_torch.models.transformer.config import ArchConfig

ALL_ARCHS = (
    "mamba2-2.7b",
    "granite-3-8b",
    "whisper-tiny",
    "gemma2-2b",
    "nemotron-4-15b",
    "internvl2-26b",
    "gemma3-27b",
    "hymba-1.5b",
    "grok-1-314b",
    "llama4-scout-17b-a16e",
)

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_").replace(".", "_") for name in ALL_ARCHS}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def list_archs() -> tuple[str, ...]:
    return ALL_ARCHS
