"""seamless-m4t-large-v2 [arXiv:2308.11596] — enc-dec; speech frontend is a
STUB (precomputed frame embeddings); 24L encoder + 24L decoder backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,                 # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    rope_theta=10_000.0,
    norm="layernorm",
    act="gelu",
    frontend="frames",
    frontend_seq=1024,
    subquadratic=False,
    attn_chunk=1024,
    remat="full",
)
