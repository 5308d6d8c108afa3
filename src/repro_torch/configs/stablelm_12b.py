"""stablelm-12b [hf:stabilityai/stablelm-2-12b] — dense, GQA kv=8,
partial rotary (25%), LayerNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    head_dim=160,
    rope_theta=10_000.0,
    rotary_pct=0.25,               # stablelm-2 partial rotary
    norm="layernorm",
    act="swiglu",
    subquadratic=False,
    attn_chunk=1024,
    remat="full",
)
