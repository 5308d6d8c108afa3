"""zamba2-2.7b [arXiv:2411.15242] — Mamba2 backbone + ONE shared attention
block (every 6 layers, per-invocation LoRA), MHA kv=32, ssm_state=64."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    shared_attn_period=6,          # 54 layers -> 9 shared-block applications
    subquadratic=True,             # Mamba2 state + windowed shared attn
    attn_chunk=1024,
    remat="full",
)
