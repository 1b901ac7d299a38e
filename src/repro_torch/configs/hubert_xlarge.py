"""hubert-xlarge — audio encoder-only, w2v2 arch [arXiv:2106.07447;
unverified].  48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Frontend (CNN feature extractor) is a stub: ``input_specs()`` supplies
precomputed frame embeddings; learned absolute positions replace the conv
positional embedding (DESIGN §4).  No decode step (encoder-only)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    causal=False,
    use_rope=False,
    act="gelu",
    frontend="audio_stub",
    max_pos_embed=32768,
)
