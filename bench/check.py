"""The comparison that decides ``correct``.

After the window, a sample of the requests served, drawn from the seed
(the request with the most served tokens always in it), is run once
through the plain reference: each prompt with its served tokens.  For
every served token the reference's logits at the position that produced
it give a gap: how far the served token's logit lies below the
reference's best.  Greedy decoding serves the best token of the
program's own logits, so the gap is rounding, and the widest gap over the
sample is compared with the cell's limit.

The control puts the reference in float8 in the program's place: at the
same positions, the token that the float8 logits put first, and its gap
in the float32 logits.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

REFS = Path(__file__).resolve().parent / "refs"


def load_reference(name: str):
    """The plain reference module ``bench/refs/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"bench_ref_{name}",
                                                  REFS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sample(served: Sequence, seed: int, min_tokens: int,
           min_requests: int = 1) -> List:
    """Served requests (each with ``prompt``, ``output`` and
    ``placement``) to compare: the one with the most served tokens, the
    one with the most among those whose heads the dispatcher put on more
    than one device (its pages staged by the exchange), then others in
    an order drawn from the seed until the sample holds ``min_tokens``
    served tokens and ``min_requests`` requests."""
    cands = [r for r in served if r.output]
    if not cands:
        return []
    most = lambda rs: max(rs, key=lambda r: (len(r.output), len(r.prompt)))
    picked = [most(cands)]
    spread = [r for r in cands if len(r.placement) > 1]
    if spread and most(spread) is not picked[0]:
        picked.append(most(spread))
    n = sum(len(r.output) for r in picked)
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 2])
    for i in rng.permutation(len(cands)):
        if n >= min_tokens and len(picked) >= min_requests:
            break
        r = cands[int(i)]
        if all(r is not p for p in picked):
            picked.append(r)
            n += len(r.output)
    return picked


def _sequence(req, device):
    """Prompt and served tokens but the last: the positions whose logits
    produced the served tokens are len(prompt) - 1 onwards."""
    toks = list(req.prompt) + list(req.output[:-1])
    return torch.tensor(toks, dtype=torch.long, device=device), \
        len(req.prompt) - 1


def gaps(ref, cfg: Dict, params: Dict, reqs: Sequence, device,
         control: bool = False):
    """Per served token of ``reqs``, the reference's best logit less its
    logit of the served token; with ``control`` also less its logit of
    the token the float8 reference puts first (else None)."""
    served, ctrl = [], []
    for r in reqs:
        toks, first = _sequence(r, device)
        lg = ref.logits(cfg, params, toks, first)
        best = lg.max(dim=-1).values
        pick = torch.tensor(r.output, dtype=torch.long, device=device)
        served.append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
        if control:
            pick = ref.logits(cfg, params, toks, first, fp8=True).argmax(-1)
            ctrl.append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
    cat = lambda xs: torch.cat(xs).numpy() if xs else np.zeros(0)
    return cat(served), (cat(ctrl) if control else None)
