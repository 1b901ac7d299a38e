"""The plain reference against the port at a tiny size on the CPU, on the
benchmark's own weights (which must be in the port's layout for this to
hold), dense and MoE (64 tokens or fewer: the port's MoE drops nothing)."""

import pytest
import torch

from bench import check, weights
from bench.tests import _tiny


@pytest.mark.parametrize("config", [_tiny.CONFIG, _tiny.MOE],
                         ids=["dense", "moe"])
def test_reference_logits_are_the_ports(config):
    from repro_torch.models import transformer as T
    from bench.harness import model_config
    params = weights.make_params(config, 3, "cpu")
    toks = torch.randint(0, config["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(0))
    ref = check.load_reference(config["reference"])
    got = ref.logits(config, params, toks, 0)
    h, _ = T.forward_hidden(model_config(config), params,
                            {"tokens": toks[None]})
    want = (h[0] @ params["lm_head"]).float()
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    # the control's float8 products move the logits well past that
    ctrl = ref.logits(config, params, toks, 0, fp8=True)
    assert (ctrl - want).abs().max() > 1e-2


def test_weights_redrawn_in_place_are_the_seeds():
    a = weights.make_params(_tiny.MOE, 5, "cpu")
    b = weights.make_params(_tiny.MOE, 9, "cpu")
    ptr = b["groups"][0]["mlp"]["wi"].data_ptr()
    weights.make_params(_tiny.MOE, 5, "cpu", into=b)
    assert b["groups"][0]["mlp"]["wi"].data_ptr() == ptr
    for x, y in zip(weights._leaves(a), weights._leaves(b)):
        assert torch.equal(x, y)
