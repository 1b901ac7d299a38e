"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
24L d_model=1024 4H d_ff=0 vocab=50304.  Attention-free: Hetis' head-wise
KV dispatch is inapplicable (DESIGN §4) — fixed-size recurrent state; the
arch is implemented without the technique.  Layers alternate (mLSTM, sLSTM)
as 12 scanned pairs."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=256,
    attn_type="none",
    use_rope=False,
    xlstm_pattern=("m", "s"),
)
