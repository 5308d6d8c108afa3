"""mixtral-8x22b [arXiv:2401.04088] — MoE 8 experts top-2, GQA kv=8, SWA.

The per-assignment SWA (4096) bounds the decode cache (ring buffer), which
is what makes the long_500k decode cell runnable for this arch."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    capacity_factor=1.25,
    subquadratic=True,             # SWA ring cache -> O(W) decode memory
    attn_chunk=1024,
    remat="full",
)
