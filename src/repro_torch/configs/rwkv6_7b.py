"""rwkv6-7b "Finch" [arXiv:2404.05892] — attention-free, data-dependent
decay; O(1) decode state -> long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    num_layers=32,
    d_model=4096,
    num_heads=64,                  # head size fixed at 64 -> 64 heads
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    subquadratic=True,
    attn_chunk=1024,               # outer seq chunk (WKV inner chunk = 16)
    remat="full",
)
