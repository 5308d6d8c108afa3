"""qwen1.5-110b [hf:Qwen/Qwen1.5-110B] — dense, GQA, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,                 # Qwen1.5 attention projections carry bias
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    subquadratic=False,            # full causal attention -> long_500k skipped
    attn_chunk=512,   # bounds the (B,H,C,S) f32 score transient
    remat="full",
)
