"""Config system: one frozen dataclass describes every supported family.

Port of ``repro.configs.base`` — the port keeps its own copy (no import
of the reference).  Families: dense | moe | rwkv | hybrid | vlm |
encdec, all built by ``models/model_zoo.py``.
``reduced()`` derives the small CPU smoke-test version of the same
family.  ``dispatch_backend`` names a ``core.crossbar`` backend:
'einsum' | 'kernel' (dense CUDA crossbar) | 'sparse' (tile-skipping
CUDA crossbar) | 'auto' | 'reference'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | rwkv | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False                  # qwen1.5 uses QKV bias
    rope_theta: float = 1e4
    rotary_pct: float = 1.0                 # stablelm-2 uses partial rotary
    sliding_window: int = 0                 # 0 = full causal (mixtral: 4096)
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    act: str = "swiglu"                     # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25

    # SSM / RWKV
    ssm_state: int = 0                      # mamba2 state size N
    ssm_head_dim: int = 64                  # mamba2 P
    conv_width: int = 4
    ssm_expand: int = 2

    # hybrid (zamba2): one shared attention block applied every k ssm blocks
    shared_attn_period: int = 0

    # enc-dec (seamless)
    encoder_layers: int = 0

    # modality frontend stubs (vlm / audio): precomputed embeddings
    frontend: str = "none"                  # none | patch | frames
    frontend_seq: int = 0                   # patches / frames per sample

    # numerics & memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                     # full | none

    # scheduling hint (minicpm trains with WSD)
    lr_schedule: str = "cosine"             # cosine | wsd

    # long-context eligibility (sub-quadratic attention or attention-free)
    subquadratic: bool = False

    # training-time attention chunk (bounds the S x S transient)
    attn_chunk: int = 1024

    # MoE dispatch backend (see the module docstring)
    dispatch_backend: str = "einsum"

    # Unroll the reference's lax.scans (its dry-run cost compiles).  Kept
    # so a reference config converts field for field; the port has no
    # scans and ignores it.
    scan_unroll: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the logits axis shards evenly over 'model'
        (MaxText-style padding; padded ids are never emitted by data)."""
        return _round_up(self.vocab_size, 2048)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd, h, kv = self.hd, self.num_heads, self.num_kv_heads
        attn = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
        if self.family in ("dense", "vlm"):
            mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
            per_layer = attn + mlp
            n = self.num_layers * per_layer
        elif self.family == "moe":
            mlp = self.num_experts * 3 * d * f + d * self.num_experts
            per_layer = attn + mlp
            n = self.num_layers * per_layer
        elif self.family == "rwkv":
            tm = 4 * d * d + d * d  # r,k,v,g,o (+ small lora terms elided)
            cm = 2 * d * self.d_ff
            n = self.num_layers * (tm + cm)
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            # in_proj -> [z, x, B, C, dt] + out_proj (Mamba blocks carry no MLP)
            ssm = d * (2 * di + 2 * self.ssm_state +
                       di // self.ssm_head_dim) + di * d
            n = self.num_layers * ssm
            # one shared attention block: 2d-wide QKV + output + its MLP
            shared = (2 * d) * (h * hd) + 2 * (2 * d) * (kv * hd) + (h * hd) * d
            shared += 3 * d * f if self.act == "swiglu" else 2 * d * f
            n += shared
        elif self.family == "encdec":
            mlp = 2 * d * f
            n = (self.num_layers + self.encoder_layers) * (attn + mlp)
            n += self.num_layers * attn  # cross-attention
        else:
            raise ValueError(self.family)
        n += v * d * (1 if self.tie_embeddings else 2)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        inactive = (self.num_experts - self.num_experts_per_tok) * 3 * d * f
        return total - self.num_layers * inactive


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        name=cfg.name + "-reduced",
        family=cfg.family,
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_ff=128,
        vocab_size=128,
        head_dim=16,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        rotary_pct=cfg.rotary_pct,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        norm=cfg.norm,
        act=cfg.act,
        tie_embeddings=cfg.tie_embeddings,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        capacity_factor=cfg.capacity_factor,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        conv_width=cfg.conv_width,
        ssm_expand=cfg.ssm_expand,
        shared_attn_period=min(cfg.shared_attn_period, 2) if cfg.shared_attn_period else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        frontend=cfg.frontend,
        frontend_seq=min(cfg.frontend_seq, 8) if cfg.frontend_seq else 0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
        lr_schedule=cfg.lr_schedule,
        subquadratic=cfg.subquadratic,
        attn_chunk=8,
        dispatch_backend=cfg.dispatch_backend,
    )
    base.update(overrides)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# Input-shape cells (assigned): every arch is exercised on these.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeCell("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeCell("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeCell("long_500k",   524_288, 1,   "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (skip reason otherwise)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention: 500k-token cache/scores "
                       "infeasible; skipped per brief (see DESIGN.md §5)")
    return True, ""
