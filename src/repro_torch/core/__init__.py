"""Core of the port: semirings, control transforms, plans and the
crossbar, the plan algebra, plan programs and the static registry.

Public API re-exports, the same names as ``repro.core``'s.
"""

from repro_torch.core.transform import (
    DROP,
    compress_destinations,
    compress_keep_count,
    destinations_are_bijective,
    exclusive_cumsum,
    exclusive_suffix_sum,
    gather_sources_from_destinations,
    slide_destinations,
)
from repro_torch.core.crossbar import (
    GATHER,
    SCATTER,
    PermutePlan,
    apply_plan,
    build_onehot,
    coverage,
    gather_plan,
    scatter_plan,
    transpose_plan,
    vcompress_plan,
    vrgather_plan,
    vslide_plan,
)
from repro_torch.core.permute import (
    lazy,
    vcompress,
    vcompress_batched,
    vexpand,
    vmerge,
    vrgather,
    vslide1down,
    vslide1up,
    vslidedown,
    vslideup,
)
from repro_torch.core.plan_algebra import (
    PlanExpr,
    batch,
    batched_gather_plan,
    batched_scatter_plan,
    block_diag,
    compose,
    compose_all,
    identity_plan,
    to_gather,
    transpose,
    with_semiring,
    with_weights,
)
from repro_torch.core.plan_program import (
    PlanProgram,
    ProgramBuilder,
    Step,
    run_program,
)
from repro_torch.core.semiring import GF2, GF2_8, REAL, Semiring
from repro_torch.core.static_registry import (
    FixedLatencyError,
    StaticPlanRegistry,
    program_step_fingerprint,
    schedule_fingerprint,
)
from repro_torch.core.bitwidth import bit_permute, from_bit_rows, to_bit_rows
from repro_torch.core import baselines, moe_dispatch, sequence, telemetry

__all__ = [
    "DROP", "GATHER", "SCATTER", "PermutePlan",
    "apply_plan", "build_onehot", "coverage",
    "gather_plan", "scatter_plan", "transpose_plan",
    "vcompress_plan", "vrgather_plan", "vslide_plan",
    "compress_destinations", "compress_keep_count",
    "destinations_are_bijective", "exclusive_cumsum", "exclusive_suffix_sum",
    "gather_sources_from_destinations", "slide_destinations",
    "lazy", "vcompress", "vcompress_batched", "vexpand", "vmerge",
    "vrgather", "vslide1down", "vslide1up", "vslidedown", "vslideup",
    "PlanExpr", "batch", "batched_gather_plan", "batched_scatter_plan",
    "block_diag", "compose", "compose_all", "identity_plan", "to_gather",
    "transpose", "with_semiring", "with_weights",
    "PlanProgram", "ProgramBuilder", "Step", "run_program",
    "GF2", "GF2_8", "REAL", "Semiring",
    "FixedLatencyError", "StaticPlanRegistry", "program_step_fingerprint",
    "schedule_fingerprint",
    "bit_permute", "from_bit_rows", "to_bit_rows",
    "baselines", "moe_dispatch", "sequence", "telemetry",
]
