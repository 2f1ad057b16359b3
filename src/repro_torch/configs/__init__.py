"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

The same names and numbers as the reference package's registry; the
port runs all ten archs.  ``get_one_card(arch)`` is the cut of a model
too large for one card (jamba-1.5-large-398b and deepseek-v3-671b: one
period and rank 0's share of the experts), named in the config's own
file.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "gemma2-2b", "gemma-2b", "qwen3-14b", "smollm-360m",
    "deepseek-v3-671b", "moonshot-v1-16b-a3b", "rwkv6-3b",
    "whisper-small", "qwen2-vl-7b", "jamba-1.5-large-398b",
]


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str):
    return _module(arch).config()


def get_smoke(arch: str):
    return _module(arch).smoke()


def get_one_card(arch: str):
    mod = _module(arch)
    if not hasattr(mod, "one_card"):
        raise KeyError(f"arch {arch!r} has no one-card cut; it runs whole "
                       f"(get_config)")
    return mod.one_card()
