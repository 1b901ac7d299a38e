"""hymba-1.5b — hybrid parallel attention+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention everywhere except three global layers (first,
middle, last — per the Hymba paper); the mamba path runs in parallel with
attention inside every block, outputs mean-fused after per-path RMSNorm.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    sliding_window=1024,
    global_layers=(0, 15, 31),
)
