"""deepseek-v3-671b — MLA + 1 shared + 256 routed top-8 MoE
[arXiv:2412.19437; hf].  61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; first 3 layers dense (d_ff=18432); MLA q_lora=1536
kv_lora=512 nope=128 rope=64 v=128.  MTP head not implemented (DESIGN §4:
orthogonal to serving parallelism)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,              # dense layers
    vocab_size=129280,
    head_dim=192,            # qk_nope + qk_rope (cost-model view)
    attn_type="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    rope_theta=10000.0,
)
