"""Assigned architecture configs (exact, from the public pool) + the paper's
own index-workload config.  ``get_config(arch_id)`` / ``list_archs()``."""

from __future__ import annotations

import importlib

ARCHS = [
    "whisper_base",
    "gemma2_2b",
    "granite_8b",
    "internvl2_1b",
    "granite_moe_1b_a400m",
    "grok_1_314b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}
_ALIAS.update({
    "whisper-base": "whisper_base",
    "gemma2-2b": "gemma2_2b",
    "granite-8b": "granite_8b",
    "internvl2-1b": "internvl2_1b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "grok-1-314b": "grok_1_314b",
})


def get_config(arch: str):
    mod_name = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.CONFIG


def list_archs():
    return list(ARCHS)
