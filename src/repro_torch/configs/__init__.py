"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

The same names and numbers as the reference package's registry.  The
port runs the dense attention + MLP archs and rwkv6-3b; the others raise
``KeyError`` until their modules are ported (ROADMAP.md, Queue 1 item
10).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "gemma2-2b", "gemma-2b", "qwen3-14b", "smollm-360m",
    "deepseek-v3-671b", "moonshot-v1-16b-a3b", "rwkv6-3b",
    "whisper-small", "qwen2-vl-7b", "jamba-1.5-large-398b",
]
PORTED = ("gemma2-2b", "gemma-2b", "qwen3-14b", "smollm-360m", "rwkv6-3b")


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    if arch not in PORTED:
        raise KeyError(f"arch {arch!r} is not yet ported to repro_torch "
                       f"(its mixer or feed-forward modules are still to "
                       f"port, see ROADMAP.md Queue 1 item 10); ported: "
                       f"{list(PORTED)}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str):
    return _module(arch).config()


def get_smoke(arch: str):
    return _module(arch).smoke()
