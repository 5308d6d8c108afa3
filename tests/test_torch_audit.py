"""The fixed-latency audit of the PyTorch port against the reference's.

Mirrors the reference's audit tests (``test_semiring.py``'s
``TestConstantTimeAudit``, ``test_gcm.py``'s ``TestConstantTime``,
``test_crypto.py``'s AES round audit and ``test_plan_program.py``'s
megakernel audit):

* ``StaticPlanRegistry.audit_constant_time`` runs a region under
  ``FakeTensorMode``; a value-dependent host sync (the "leaky" ``int()``
  and the "branchy" ``if``) raises ``FixedLatencyError``, and the
  Keccak, AES, megakernel and GCM seal/open regions pass;
* an audit leaves no fake tensor in any cache — cold (nothing built
  before it) or warm — and the next real call equals the reference;
* ``telemetry.no_host_sync`` and ``observe``/``execute(...,
  audit_host_syncs=True)`` refuse scalar reads inside the block.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensor, FakeTensorMode)

from repro_torch.core import abstract
from repro_torch.core import crossbar as txb
from repro_torch.core import plan_algebra as tpa
from repro_torch.core import plan_program as tpp
from repro_torch.core import telemetry
from repro_torch.core.static_registry import (FixedLatencyError, ShapeDtype,
                                              StaticPlanRegistry)
from repro_torch.crypto import aes as TA
from repro_torch.crypto import gcm as TG
from repro_torch.crypto import keccak as TK
from repro_torch.crypto import registry as treg
from repro_torch.kernels import ref as kref
from test_torch_gcm import KEY, gcm_ref
from test_torch_support import (assert_bitexact, jax_ref,  # noqa: F401
                                one_thread, reset_torch_state)

CPU = torch.device("cpu")

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def cold_registries(monkeypatch):
    """No crypto plan, program, schedule or memo entry built yet."""
    monkeypatch.setattr(treg, "_REGISTRIES", {})
    telemetry.reset()


# -- the audit's verdicts ------------------------------------------------------

def test_value_dependent_sync_trips():
    reg = StaticPlanRegistry("unit-audit")

    def leaky(x):
        return x * int(torch.sum(x))  # schedule depends on payload

    with pytest.raises(FixedLatencyError, match="host sync"):
        reg.audit_constant_time("leaky", leaky,
                                torch.zeros(4, dtype=torch.int32))


def test_value_dependent_branch_trips():
    reg = StaticPlanRegistry("unit-audit")

    def branchy(x):
        if torch.sum(x) > 0:  # bool() on payload
            return x
        return -x

    with pytest.raises(FixedLatencyError, match="host sync"):
        reg.audit_constant_time("branchy", branchy,
                                torch.ones(4, dtype=torch.int32))


@pytest.mark.parametrize("read", ["tolist", "numpy", "item"])
def test_every_payload_read_trips(read):
    reg = StaticPlanRegistry("unit-audit")

    def region(x):
        getattr(x.sum(), read)()
        return x

    with pytest.raises(FixedLatencyError, match="host sync"):
        reg.audit_constant_time(read, region,
                                torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("backend", ["einsum", "kernel", "sparse"])
def test_clean_crossbar_pass_passes(backend, dtype):
    """A crossbar pass on every backend; an integer payload's float32
    range check has no values to read on a fake payload (the reference
    skips it on a traced one)."""
    reg = StaticPlanRegistry("unit-audit")
    plan = txb.gather_plan(torch.tensor([1, 0, 2], dtype=torch.int32), 3)
    out = reg.audit_constant_time(
        "clean", lambda v: txb.apply_plan(plan, v, backend=backend),
        torch.zeros((3, 2), dtype=dtype))
    assert out.shape == (3, 2) and out == ShapeDtype((3, 2), dtype)


def test_audit_returns_the_output_tree():
    reg = StaticPlanRegistry("unit-audit")
    out = reg.audit_constant_time(
        "tree", lambda a, *, b: {"sum": a + b, "pair": (a[:1], b.sum())},
        torch.zeros(3), b=torch.ones(3))
    assert out == {"sum": ShapeDtype((3,), torch.float32),
                   "pair": (ShapeDtype((1,), torch.float32),
                            ShapeDtype((), torch.float32))}


def test_audit_moves_no_data():
    """Abstract evaluation: the region sees fake tensors only."""
    seen = []
    StaticPlanRegistry("unit-audit").audit_constant_time(
        "types", lambda x: seen.append(type(x)) or x, torch.zeros(2))
    assert seen == [FakeTensor]


def test_crypto_round_functions_are_constant_time():
    reg = StaticPlanRegistry("unit-audit")
    out = reg.audit_constant_time(
        "keccak", lambda b: TK.keccak_f1600(b),
        torch.zeros(1600, dtype=torch.int32))
    assert out == ShapeDtype((1600,), torch.int32)


def test_constant_time_audit_over_program():
    prog = TK.megakernel_program(CPU)
    out = StaticPlanRegistry("unit-audit").audit_constant_time(
        "keccak-megakernel",
        lambda x: tpp.run_program(prog, x, backend="megakernel"),
        torch.zeros((1600, 4), dtype=torch.int32))
    assert out.shape == (1600, 4)


def test_aes_round_function_passes_constant_time_audit():
    """The whole fused encrypt state function abstract-evaluates with the
    state fake: no value-dependent host sync."""
    TA._ensure_plans(False, True, CPU)
    rks = torch.as_tensor(TA.key_expansion(KEY), dtype=torch.int32)
    out = treg.registry(CPU).audit_constant_time(
        "aes128-round", lambda s: TA._cipher_state(
            s, rks, inverse=False, fuse_layers=True, backend="einsum"),
        torch.zeros((16, 1), dtype=torch.int32))
    assert out == ShapeDtype((16, 1), torch.int32)


@pytest.mark.parametrize("geometry", [(53, 18, False, 8), (32, 0, True, 2)],
                         ids=["seal_53_18", "open_32_0"])
def test_audit_full_gcm_program(cold_registries, geometry):
    """The complete fused seal (every AES round, the counters, the GHASH
    absorb, the tag) and the open program abstract-evaluate with a fake
    state; then the same region runs for real and equals the oracle."""
    pt_len, aad_len, open_mode, lanes = geometry
    fn, lay = TG.seal_device_fn(KEY, pt_len, aad_len, open_mode=open_mode,
                                device=CPU)
    out = treg.registry(CPU).audit_constant_time(
        "gcm_audit", fn, torch.zeros((lay["n"], lanes), dtype=torch.int32))
    assert out == ShapeDtype((lay["n"], lanes), torch.int32)
    assert abstract.fake_cache_entries() == []

    rng = np.random.default_rng(5)
    iv = rng.integers(0, 256, 12, dtype=np.uint8).tobytes()
    pt = rng.integers(0, 256, pt_len, dtype=np.uint8).tobytes()
    aad = rng.integers(0, 256, aad_len, dtype=np.uint8).tobytes()
    ct, tag = gcm_ref(KEY, iv, pt, aad)
    if open_mode:
        assert TG.aes128_gcm_open(KEY, iv, ct + tag, aad, device=CPU) == pt
    else:
        assert TG.aes128_gcm_seal(KEY, iv, pt, aad, device=CPU) == ct + tag


# -- no cache keeps a fake tensor ------------------------------------------------

@pytest.mark.parametrize("backend", ["einsum", "megakernel"])
def test_cold_keccak_audit_leaves_no_fake_in_caches(cold_registries, jax_ref,
                                                    backend):
    """The regression: a keccak_f1600 audit on nothing built used to
    register a plan with fake control, and the next real call failed."""
    import jax.numpy as jnp
    from repro.crypto import keccak as JK

    x = np.random.default_rng(3).integers(0, 2, (2, 1600)).astype(np.int32)
    reg = treg.registry(CPU)
    out = reg.audit_constant_time(
        "keccak-cold", lambda b: TK.keccak_f1600(b, backend=backend),
        torch.zeros((2, 1600), dtype=torch.int32))
    assert out == ShapeDtype((2, 1600), torch.int32)
    assert "keccak/rho_pi" in reg or TK.MEGAKERNEL_PROGRAM_KEY in \
        reg._programs
    assert abstract.fake_cache_entries() == []
    got = TK.keccak_f1600(torch.as_tensor(x), backend=backend)
    assert_bitexact(got, JK.keccak_f1600(jnp.asarray(x),
                                         backend="reference"))


def test_warm_audit_leaves_no_fake_in_caches():
    x = torch.as_tensor(
        np.random.default_rng(4).integers(0, 2, 1600).astype(np.int32))
    want = TK.keccak_f1600(x)
    treg.registry(CPU).audit_constant_time(
        "keccak-warm", TK.keccak_f1600, torch.zeros(1600, dtype=torch.int32))
    assert abstract.fake_cache_entries() == []
    assert_bitexact(TK.keccak_f1600(x), want)


def test_payload_derived_plan_is_refused_not_cached():
    """A plan built from the payload stays fake: its schedule's host read
    raises, and neither the memo nor the registry keeps it."""
    reg = StaticPlanRegistry("unit-audit")

    def gather_by_payload(x):
        plan = txb.gather_plan(x[:, None].to(torch.int32), 4)
        return txb.apply_plan(tpa.compose(plan, plan), x.to(torch.float32),
                              backend="sparse")

    with pytest.raises(FixedLatencyError, match="host sync"):
        reg.audit_constant_time("derived", gather_by_payload,
                                torch.zeros(4, dtype=torch.int64))
    with pytest.raises(FixedLatencyError, match="payload"):
        reg.audit_constant_time(
            "registered", lambda x: reg.get_or_register(
                "from-payload", lambda: txb.gather_plan(
                    x[:, None].to(torch.int32), 4)),
            torch.zeros(4, dtype=torch.int64))
    assert "from-payload" not in reg
    assert abstract.fake_cache_entries() == []


def test_static_control_reads_stay_real_and_payload_reads_raise():
    real = torch.arange(4, dtype=torch.int32)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = mode.from_tensor(real)
        with abstract.concrete(real):
            assert int(real.sum()) == 6
            assert real.tolist() == [0, 1, 2, 3]
        with abstract.concrete(real, fake):
            with pytest.raises(DataDependentOutputException):
                int(fake.sum())
    assert abstract.holds_fake(fake) and not abstract.holds_fake(real)


def test_plain_vm_walks_real_control_on_a_fake_state():
    prog = TK.megakernel_program(CPU)
    ctl = tpp.control_for(prog, CPU)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        state = mode.from_tensor(torch.zeros((1600, 2), dtype=torch.int32))
        out = kref.plan_program_vm(state, *tpp.vm_operands(ctl),
                                   n_regs=prog.n_regs, rounds=prog.rounds,
                                   const_stride=prog.const_stride)
    assert isinstance(out, FakeTensor) and out.shape == (1600, 2)


# -- host-sync audit of real execution -------------------------------------------

@pytest.mark.parametrize("read", [
    lambda x: int(x.sum()), lambda x: float(x.sum()),
    lambda x: bool(x.sum() > 0), lambda x: x.sum().item()],
    ids=["int", "float", "bool", "item"])
def test_no_host_sync_refuses_scalar_reads(read):
    x = torch.arange(4)
    with pytest.raises(telemetry.HostSyncError):
        with telemetry.no_host_sync():
            read(x)
    assert int(x.sum()) == 6          # the guard is gone after the block


def test_no_host_sync_passes_other_errors_and_device_work():
    with telemetry.no_host_sync():
        y = torch.arange(4) * 2 + 1
    assert y.tolist() == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="unrelated"):
        with telemetry.no_host_sync():
            raise ValueError("unrelated")


def test_observe_audit_flag_converts_host_syncs():
    reg = StaticPlanRegistry("unit-audit")
    with pytest.raises(FixedLatencyError, match="host sync"):
        with reg.observe("concretize", audit_host_syncs=True):
            int(torch.tensor(3))
    with pytest.raises(FixedLatencyError, match="fake"):
        with reg.observe("concretize-fake", audit_host_syncs=True):
            with FakeTensorMode() as mode:
                int(mode.from_tensor(torch.tensor(3)))


def test_observe_without_audit_reraises_fake_reads():
    reg = StaticPlanRegistry("unit-audit")
    with reg.observe("concretize-noaudit"):
        assert int(torch.tensor(3)) == 3
    with pytest.raises(DataDependentOutputException):
        with reg.observe("concretize-fake-noaudit"):
            with FakeTensorMode() as mode:
                int(mode.from_tensor(torch.tensor(3)))


@pytest.mark.parametrize("backend", ["einsum", "kernel", "sparse"])
def test_execute_with_host_sync_audit(backend):
    reg = StaticPlanRegistry("unit-audit")
    reg.register("rot", txb.gather_plan(
        torch.tensor([2, 0, 1, 3], dtype=torch.int32), 4))
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    want = reg.execute("rot", x, backend=backend)
    for _ in range(2):
        got = reg.execute("rot", x, backend=backend, fixed_latency=True,
                          audit_host_syncs=True)
        assert_bitexact(got, want)
