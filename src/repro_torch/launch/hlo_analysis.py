"""Roofline terms of a step on one H100: the reference's
``repro.launch.hlo_analysis.roofline_terms`` with this card's peaks.

PyTorch runs eagerly and has no HLO, so the reference's ``parse_hlo``,
``analyze`` and ``parse_collectives`` have no counterpart here; the
dry-run counts FLOPs with ``torch.utils.flop_counter`` instead.

Hardware constants: one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s
bf16, 3.35 TB/s HBM.  One card has no collectives, so the collective term
is 0.  The terms are models of the card, not measurements.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS_BF16 = 989e12        # per card
HBM_BW = 3.35e12                # per card


def roofline_terms(flops: float, hbm_bytes: float) -> Dict[str, float]:
    """The reference's three terms in seconds for one card's totals; the
    collective term is 0 (nothing leaves the card)."""
    return {"compute_s": flops / PEAK_FLOPS_BF16,
            "memory_s": hbm_bytes / HBM_BW,
            "collective_s": 0.0}
