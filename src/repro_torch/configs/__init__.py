"""Architecture registry of the port: the ten architectures the reference
has.

The main path's configs are pure-GQA full-attention stacks with dense MLP
or MoE layers (qwen3-14b, qwen1.5-0.5b, phi3-mini, minitron-8b and dbrx),
which the engine serves.  The other families (hymba's SSM hybrid with
sliding windows, deepseek-v3's MLA, xLSTM, and the vision and audio stub
frontends of internvl2 and hubert) run through the model functions
``prefill``, ``decode_step`` and ``forward_hidden``, as in the reference.
``get_config`` returns the published config; ``smoke_config`` a reduced
same-family sibling for CPU tests; ``SHAPES`` and ``cells()`` enumerate
the (arch, shape) grid that ``launch.steps`` builds and ``launch.dryrun``
sizes.  Names and module layout follow ``repro.configs``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

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


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


# ---------------------------------------------------------------------------
# Input shapes (the reference's ``repro.configs.SHAPES``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str              # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped), the reference's rule."""
    if cfg.is_encoder_only and shape.step == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; 500k decode skipped (DESIGN §4)"
    return True, ""


def cells(include_skipped: bool = False
          ) -> List[Tuple[str, str, bool, str]]:
    """All (arch, shape, runnable, skip_reason) cells — 40 total."""
    out = []
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for sname, spec in SHAPES.items():
            ok, why = shape_applicable(cfg, spec)
            if ok or include_skipped:
                out.append((arch, sname, ok, why))
    return out
