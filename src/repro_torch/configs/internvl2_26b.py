"""internvl2-26b [arXiv:2404.16821] — InternViT frontend (STUB: precomputed
patch embeddings) + InternLM2-20B 48L language backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    frontend="patch",
    frontend_seq=256,              # patch prefix length from the stub
    subquadratic=False,
    attn_chunk=1024,
    remat="full",
)
