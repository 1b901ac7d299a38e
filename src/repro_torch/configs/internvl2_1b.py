"""internvl2-1b — InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The brief specifies
the transformer BACKBONE only; the vision frontend is a stub supplying 256
precomputed patch embeddings prepended to the token stream."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1000000.0,
    frontend="vision_stub",
    n_prefix_embeds=256,
)
