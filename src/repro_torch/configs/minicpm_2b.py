"""minicpm-2b [arXiv:2404.06395] — llama-like dense, MHA kv=36, tied
embeddings, trained with the WSD schedule (implemented in optim/schedules)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    lr_schedule="wsd",
    subquadratic=False,
    attn_chunk=1024,
    remat="full",
)
