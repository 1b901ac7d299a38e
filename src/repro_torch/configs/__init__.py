"""Architecture registry of the port: the ten architectures the reference
has.

The main path's configs are pure-GQA full-attention stacks with dense MLP
or MoE layers (qwen3-14b, qwen1.5-0.5b, phi3-mini, minitron-8b and dbrx),
which the engine serves.  The other families (hymba's SSM hybrid with
sliding windows, deepseek-v3's MLA, xLSTM, and the vision and audio stub
frontends of internvl2 and hubert) run through the model functions
``prefill``, ``decode_step`` and ``forward_hidden``, as in the reference.
``get_config`` returns the published config; ``smoke_config`` a reduced
same-family sibling for CPU tests.  Names and module layout follow
``repro.configs``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_NAMES = [
    "hymba_1p5b",
    "dbrx_132b",
    "deepseek_v3_671b",
    "hubert_xlarge",
    "internvl2_1b",
    "phi3_mini_3p8b",
    "qwen1p5_0p5b",
    "minitron_8b",
    "qwen3_14b",
    "xlstm_350m",
]

# canonical ids -> module names
ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-1b": "internvl2_1b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "minitron-8b": "minitron_8b",
    "qwen3-14b": "qwen3_14b",
    "xlstm-350m": "xlstm_350m",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    return get_config(name).reduced()
