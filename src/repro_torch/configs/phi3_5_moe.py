"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct] — MoE 16e top-2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    capacity_factor=1.25,
    subquadratic=False,            # full attention
    attn_chunk=1024,
    remat="full",
)
