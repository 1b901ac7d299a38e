"""The design of B3's bf16 forward (``csrc/flash_attention.cu``,
``fwd_wgmma``: TMA-fed K/V ring, producer warpgroup, two or three
``wgmma`` consumer groups of 64 positions each), held on the CPU.

``_b3_fwd_emulation.emulate_forward`` repeats the kernel's tile walk in
plain PyTorch (per-head blocks of 64 positions a group, in the kernel's
launch order, key tiles of 64 or of 128 at dh 64, each tile classed interior / masked / skipped and the class
checked pair by pair against the mask, every tile a block does not walk
checked to hold no visible pair, exp2 in log2 units, P rounded to bf16 as
the kernel's shared-memory operand).  It is held against the port's plain
version (``flash_attention_ref``) and the reference's Pallas kernel
(interpret mode, where it takes the widths) on inputs made with numpy from
a seed: bf16 2e-2 (P rounded to bf16 before PV, which the plain version
does not do); each row's log-sum-exp against ``torch.logsumexp`` of the
plain masked scores at fp32 2e-5 (the same scores summed in another
order)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _b3_fwd_emulation import (INTERIOR, MASKED, SKIP, emulate_forward,
                               groups, key_tile, launch_order, tile_class)
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from test_torch_b3_b2_design import FLASH_CASES, inputs
from test_torch_b3_bwd_design import plain_lse

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LSE_TOL = dict(rtol=2e-5, atol=2e-5)

# FLASH_CASES (B, Hq, Hkv, Sq, Sk, dh, causal, window, Pallas block), and
# the kernel's other widths: dh 80 non-causal at S not a tile multiple
# (S's k-steps stop at dh inside the second, zero-filled box), dh 96 GQA
# r = 3 with a window that crosses tiles, dh 64's 128-key tiles over
# several blocks, and MLA's q/k 192 with v 128 (its own v width: V_DIMS;
# the Pallas kernel takes one width, so it is held against the plain
# version only)
FWD_CASES = {
    **FLASH_CASES,
    "dh80_noncausal": (1, 4, 4, 150, 150, 80, False, 0, 64),
    "dh96_window": (1, 6, 2, 300, 300, 96, True, 160, 64),
    "dh64_blocks": (1, 2, 2, 400, 400, 64, True, 0, 64),
    "mla_192_128": (1, 4, 4, 200, 200, 192, True, 0, 64),
}
V_DIMS = {"mla_192_128": 128}


def case_inputs(name, seed):
    """bf16 q, k, v of case ``name`` as JAX and torch arrays."""
    B, Hq, Hkv, Sq, Sk, dh = FWD_CASES[name][:6]
    dv = V_DIMS.get(name, dh)
    return inputs([(B, Hq, Sq, dh), (B, Hkv, Sk, dh), (B, Hkv, Sk, dv)],
                  "bfloat16", seed)


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_forward_emulation_matches_plain_and_pallas(name):
    causal, window, blk = FWD_CASES[name][6:]
    (jq, jk, jv), (q, k, v) = case_inputs(name, sorted(FWD_CASES).index(name))
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    got, lse = emulate_forward(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == plain.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, plain.float().numpy(), **BF16_TOL)
    want_lse = plain_lse(q, k, causal, window)
    blind = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), blind)
    assert torch.all(lse[blind] == -math.inf)
    np.testing.assert_allclose(lse[~blind].numpy(),
                               want_lse[~blind].numpy(), **LSE_TOL)
    blind = blind.numpy()
    assert np.all(got[blind] == 0)
    if name in V_DIMS:
        return
    # rows that see no key: the Pallas kernel gives them the mean of V
    # over a block it runs for their neighbours, so it is compared on the
    # other rows
    kern = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                             block_q=blk, block_k=blk), np.float32)
    np.testing.assert_allclose(got[~blind], kern[~blind], **BF16_TOL)


# the tile classes each case's walk must meet: dh 128's 64-key tiles put
# a skipped tile above the first group's diagonal; at dh 64 (128-key
# tiles, three groups) S 128 meets masked tiles and a third group past the
# end (skipped), and only from position 128 an interior tile; a window
# across tiles skips on both sides; non-causal dh 80 at S 150 leaves the
# second block's second group past the end
CLASSES_MET = {
    "mqa": {SKIP, MASKED, INTERIOR},
    "mha": {SKIP, MASKED},
    "dh64_blocks": {SKIP, MASKED, INTERIOR},
    "dh96_window": {SKIP, MASKED, INTERIOR},
    "dh80_noncausal": {SKIP, MASKED, INTERIOR},
    "sq_gt_sk_window": {SKIP, MASKED},
    "mla_192_128": {SKIP, MASKED, INTERIOR},
}


@pytest.mark.parametrize("name", sorted(CLASSES_MET))
def test_forward_walk_meets_its_tile_classes(name):
    """Each case holds the classes it is there for (each walked tile's
    class is checked against its pairs inside the emulation)."""
    causal, window = FWD_CASES[name][6:8]
    _, (q, k, v) = case_inputs(name, 7)
    met = {}
    emulate_forward(q, k, v, causal=causal, window=window, classes=met)
    assert set(met) == CLASSES_MET[name], met
    if name == "mqa":            # the diagonal tile, the one below, above
        Sq, Sk = FWD_CASES[name][3:5]
        assert key_tile(128) == 64
        assert tile_class(64, 64, 64, Sq, Sk, True, 0) == MASKED
        assert tile_class(64, 0, 64, Sq, Sk, True, 0) == INTERIOR
        assert tile_class(0, 64, 64, Sq, Sk, True, 0) == SKIP


def test_forward_tiles_depend_on_shapes_alone():
    """BSHD and BHSD views are the same tensor maps' boxes: the emulation
    of one is the emulation of the other, bit for bit."""
    _, (q, k, v) = inputs([(1, 10, 140, 64), (1, 2, 140, 64),
                           (1, 2, 140, 64)], "bfloat16", 11)
    a = emulate_forward(q, k, v, causal=True, window=0)
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    b = emulate_forward(qs, ks, vs, causal=True, window=0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# (B, Hq, Hkv, S, dqk, dv) of the launches chip_smoke.py times: qwen3-14b's
# prefill (one group: every head's K and V fit), training's forward (groups
# of 24 heads), MLA at S 4096 (groups of 9, the last of 2), and GQA r = 5
# at S 16384 (groups of 15 heads: three kv heads), the last of 10
LAUNCHES = {
    "prefill": (1, 40, 8, 1024, 128, 128, 40),
    "train_fwd": (8, 16, 16, 4096, 64, 64, 24),
    "mla_4k": (1, 128, 128, 4096, 192, 128, 9),
    "ragged_group": (4, 10, 2, 16384, 128, 128, 15),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_forward_launch_order_covers_every_block_heaviest_first(name):
    """The 1-D grid's blocks are every (batch, head, position block) once;
    a group's heads are consecutive (b, h) pairs, whole kv heads' query
    heads, and within a group the position blocks come last (heaviest)
    first."""
    B, Hq, Hkv, S, dqk, dv, heads = LAUNCHES[name]
    order = launch_order(B, Hq, Hq // Hkv, S, S, dqk, dv)
    n_pb = -(-S // (64 * groups(dqk)))
    assert sorted(order) == [(b, h, p) for b in range(B) for h in range(Hq)
                             for p in range(n_pb)]
    assert heads % (Hq // Hkv) == 0
    for g0 in range(0, len(order), heads * n_pb):
        group = order[g0:g0 + heads * n_pb]
        pairs = sorted({b * Hq + h for b, h, _ in group})
        assert pairs == list(range(pairs[0], pairs[0] + len(pairs)))
        assert len(pairs) == min(heads, B * Hq - pairs[0])
        pbs = [p for _, _, p in group]
        assert pbs == sorted(pbs, reverse=True)
