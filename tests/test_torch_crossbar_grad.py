"""The crossbar kernels have no gradient: ``apply_plan`` on 'kernel' or
'sparse' (or 'auto' resolving to one of them) refuses a payload or plan
weights that require grad while grad is enabled, on every device, as the
reference refuses to differentiate its Pallas kernels.  'einsum'
differentiates; under ``no_grad`` / ``inference_mode`` the kernels run
as before.  On the CPU the kernel backends run their plain versions, so
the refusal is checked before dispatch."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import phi3_5_moe as tphi
from repro_torch.configs.base import reduced
from repro_torch.core import crossbar as xb
from repro_torch.core import moe_dispatch as md
from repro_torch.kernels._build import KernelLaunchError
from repro_torch.models import moe as tM
from test_torch_support import one_thread, reset_torch_state  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _weighted_gather(requires_grad_x, requires_grad_w, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(-2, 12, (10, 2)).astype(np.int32))
    w = torch.as_tensor(rng.standard_normal((10, 2)).astype(np.float32))
    x = torch.as_tensor(rng.standard_normal((12, 3)).astype(np.float32))
    x.requires_grad_(requires_grad_x)
    w.requires_grad_(requires_grad_w)
    return xb.gather_plan(idx, 12, weights=w), x, w


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
@pytest.mark.parametrize("which", ["payload", "weights", "both"])
def test_kernel_backends_refuse_a_gradient(backend, which):
    plan, x, _ = _weighted_gather(which != "weights", which != "payload")
    before = xb.apply_calls_by_backend()
    with pytest.raises(KernelLaunchError, match="no gradient"):
        xb.apply_plan(plan, x, backend=backend)
    assert xb.apply_calls_by_backend().get(backend, 0) == before.get(
        backend, 0)


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "detached"])
def test_kernel_backends_run_without_a_gradient(backend, mode):
    plan, x, w = _weighted_gather(True, True)
    want = xb.apply_plan(plan, x.detach(), backend="einsum")
    if mode == "detached":
        plan = xb.gather_plan(plan.idx, 12, weights=w.detach())
        got = xb.apply_plan(plan, x.detach(), backend=backend)
    else:
        ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
        with ctx():
            got = xb.apply_plan(plan, x, backend=backend)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


def test_auto_refuses_when_it_resolves_to_a_kernel():
    class Table:
        def __init__(self, pick):
            self.pick = pick

        def best(self, kind, geometry):
            return self.pick

    plan, x, _ = _weighted_gather(True, False)
    try:
        for pick in ("kernel", "sparse"):
            xb.set_tuning_table(Table(pick))
            with pytest.raises(KernelLaunchError, match=f"'{pick}'"):
                xb.apply_plan(plan, x, backend="auto")
        xb.set_tuning_table(Table("einsum"))
        out = xb.apply_plan(plan, x, backend="auto")
        assert out.requires_grad
    finally:
        xb.set_tuning_table(None)


def test_einsum_differentiates_payload_and_gates():
    """The gradient through a weighted gather: d/dx and d/dw of
    sum(out * c), against the formula."""
    plan, x, w = _weighted_gather(True, True, seed=1)
    c = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (10, 3)).astype(np.float32))
    (xb.apply_plan(plan, x, backend="einsum") * c).sum().backward()
    idx = plan.idx.long()
    valid = (idx >= 0) & (idx < 12)
    gx = torch.zeros_like(x)
    gw = torch.zeros_like(w)
    for o in range(10):
        for j in range(2):
            if valid[o, j]:
                gx[idx[o, j]] += w[o, j].detach() * c[o]
                gw[o, j] = (x[idx[o, j]].detach() * c[o]).sum()
    np.testing.assert_allclose(x.grad.numpy(), gx.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), gw.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "sparse"])
def test_moe_layer_on_a_kernel_backend_refuses_training(backend):
    """An MoE layer whose config dispatches on a kernel backend raises
    under grad instead of returning a result whose router and payload
    gradients are silently zero; under no_grad it runs."""
    cfg = dataclasses.replace(reduced(tphi.CONFIG), dispatch_backend=backend)
    p = tM.moe_mlp_init(torch.Generator().manual_seed(0), cfg, "cpu")
    p["router"]["w"].requires_grad_(True)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with pytest.raises(KernelLaunchError, match="no gradient"):
        tM.moe_mlp_apply(p, x, cfg)
    with torch.no_grad():
        y, _ = tM.moe_mlp_apply(p, x, cfg)
    y_e, _ = tM.moe_mlp_apply(p, x, dataclasses.replace(
        cfg, dispatch_backend="einsum"))
    np.testing.assert_allclose(y.numpy(), y_e.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    y_e.sum().backward()
    assert float(p["router"]["w"].grad.abs().sum()) > 0


def test_combine_gates_carry_the_router_gradient():
    """Nothing between the router logits and the combine plan's weights
    detaches them: the gates of a routing keep their autograd history."""
    logits = torch.randn(2, 6, 4, requires_grad=True)
    routing = md.make_routing(logits, num_experts=4, k=2, capacity=3)
    plan = md.combine_plan(routing)
    assert plan.weights.requires_grad and routing.gates.requires_grad
    y = md.combine(torch.randn(2, 4, 3, 5), routing)
    y.sum().backward()
    assert float(logits.grad.abs().sum()) > 0
