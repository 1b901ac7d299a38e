"""Architecture registry of the port.

Holds the architectures whose serving path the port runs: the configs of
the main path, pure-GQA full-attention stacks with dense MLP or MoE
layers (qwen3-14b, qwen1.5-0.5b, phi3-mini, minitron-8b and dbrx).
``get_config`` returns the published config; ``smoke_config`` a reduced
same-family sibling for CPU tests.  Names and module layout follow
``repro.configs`` so further architectures drop in as one module each.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_NAMES = [
    "dbrx_132b",
    "phi3_mini_3p8b",
    "qwen1p5_0p5b",
    "minitron_8b",
    "qwen3_14b",
]

# canonical ids -> module names
ALIASES = {
    "dbrx-132b": "dbrx_132b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "minitron-8b": "minitron_8b",
    "qwen3-14b": "qwen3_14b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_NAMES:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP Queue A "
            f"item 7: model families off the main path); ported: "
            f"{sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    return get_config(name).reduced()
