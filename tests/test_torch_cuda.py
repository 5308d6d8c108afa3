"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the test) when there is no
CUDA device with ``nvcc``.  On a machine with the card:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports the JAX package.)
"""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_support import (assert_bitexact, assert_close,
                                reset_torch_state)  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    import repro_torch
    caps = repro_torch.capabilities()
    if not caps.can_build_kernels:
        pytest.skip("needs an sm_90 CUDA device and nvcc")
    return torch.device("cuda", 0)


def test_crossbar_kernels_match_plain_versions(dev):
    from repro_torch.core import crossbar as txb
    from repro_torch.kernels import launch_counts
    rng = np.random.default_rng(0)
    for mode in ("gather", "scatter"):
        idx = torch.as_tensor(rng.integers(-5, 700, (700, 3)).astype(
            np.int32), device=dev)
        w = torch.as_tensor(rng.standard_normal((700, 3)).astype(
            np.float32), device=dev)
        fn = txb.gather_plan if mode == "gather" else txb.scatter_plan
        plan = fn(idx, 700, weights=w)
        x = torch.as_tensor(rng.standard_normal((700, 40)).astype(
            np.float32), device=dev)
        want = txb.apply_plan(plan, x, backend="reference")
        for backend in ("kernel", "sparse"):
            assert_close(txb.apply_plan(plan, x, backend=backend), want)
    counts = launch_counts()
    assert counts["crossbar_dense"] > 0 and counts["crossbar_sparse"] > 0


def test_sha3_on_every_backend(dev):
    from repro_torch.crypto import keccak
    for backend in ("einsum", "kernel", "sparse", "megakernel"):
        assert keccak.sha3_256(b"abc", backend=backend, device=dev) == \
            hashlib.sha3_256(b"abc").digest()
    s = torch.as_tensor(np.random.default_rng(1).integers(
        0, 2, (8, 1600)).astype(np.int32), device=dev)
    assert_bitexact(keccak.keccak_f1600(s, backend="megakernel"),
                    keccak.keccak_f1600(s.cpu(), backend="megakernel"))
