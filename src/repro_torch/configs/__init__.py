"""Assigned-architecture registry: ``get_config(arch_id)``.

A copy of ``repro/configs`` (dimensions only, no JAX), so that the port
imports nothing of the reference package.

Each module defines ``CONFIG`` built from the published configuration
cited in its docstring.  ``ARCHS`` lists every selectable ``--arch``.
"""
from importlib import import_module

ARCHS = [
    "seamless_m4t_medium",
    "mamba2_780m",
    "dbrx_132b",
    "olmoe_1b_7b",
    "qwen3_0_6b",
    "starcoder2_15b",
    "gemma3_1b",
    "olmo_1b",
    "zamba2_7b",
    "llama_3_2_vision_11b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str):
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    mod = import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
