"""starcoder2-15b [arXiv:2402.19173] — dense, GQA kv=4, RoPE, LayerNorm/GeLU,
sliding-window 4096 attention (kept faithful; the arch is still graded as
dense -> long_500k skipped per the brief's family rule, see DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    qkv_bias=True,                 # StarCoder2 uses bias on attention/MLP
    rope_theta=100_000.0,
    norm="layernorm",
    act="gelu",
    sliding_window=4096,
    subquadratic=False,
    attn_chunk=1024,
    remat="full",
)
