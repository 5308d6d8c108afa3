"""The AEAD chaos sweep of the port's continuous-batching engine on the
CPU.

Mirrors ``TestAEADChaosSweep`` of the reference's
``tests/test_batching.py``: records sealed through the engine under
injected megakernel faults and silent cache corruption, every tag
bit-exact against the clean run.  A file of its own, beside
``test_torch_batching.py`` (whose engine helpers it uses), so that a
parallel run can give the sweep a worker of its own.
"""

import os

import numpy as np
import pytest

from repro_torch.core import faults, integrity, telemetry
from repro_torch.crypto import gcm
from repro_torch.serve.batching import encode_aead_record
from test_torch_batching import _drain, _engine
from test_torch_support import reset_torch_state  # noqa: F401

pytestmark = pytest.mark.chaos


class TestAEADChaosSweep:
    """Records sealed through the engine under 1 % injected megakernel
    faults plus silent cache corruption: every tag bit-exact against the
    clean run (itself spot-checked against the pure-Python GCM), the
    integrity guards catching the corruption before a poisoned tag is
    served, and a tampered tag rejected without leaking plaintext.

    ``CHAOS_AEAD_RECORDS`` sets the sweep size; the default is a CPU
    lap of 1024 records (the reference's default, 10^4, on request).
    """

    KEY = bytes(range(16))
    PT_LEN, AAD_LEN = 32, 8

    def _records(self, n):
        rng = np.random.default_rng(0xC0FFEE)
        return [(i.to_bytes(12, "big"), rng.bytes(self.PT_LEN),
                 rng.bytes(self.AAD_LEN)) for i in range(n)]

    def _seal_all(self, recs, mid_hook=None):
        eng = _engine(aead_key=self.KEY, max_batch=128, max_queue=256,
                      chain=("megakernel", "einsum"))
        out = []
        step = 128
        for start in range(0, len(recs), step):
            if mid_hook is not None and start >= len(recs) // 2:
                mid_hook()
                mid_hook = None
            wave = recs[start:start + step]
            reqs = [eng.submit(encode_aead_record(n, p, a), op="gcm_seal")
                    for n, p, a in wave]
            _drain(eng)
            out.extend(r.result(timeout=120) for r in reqs)
        return out

    def test_chaos_sweep_bit_exact_tags(self):
        from test_torch_gcm import gcm_ref
        n = int(os.environ.get("CHAOS_AEAD_RECORDS", "1024"))
        recs = self._records(n)

        clean = self._seal_all(recs)
        for i in np.random.default_rng(7).choice(
                n, size=min(24, n), replace=False):
            nonce, pt, aad = recs[i]
            ct, tag = gcm_ref(self.KEY, nonce, pt, aad)
            assert clean[i] == ct + tag, f"oracle mismatch at record {i}"

        before = telemetry.snapshot()
        with integrity.always_verify():
            with faults.inject_faults(seed=11, program_rate=0.01,
                                      corrupt_cache_rate=0.01,
                                      max_faults=8) as inj:
                chaotic = self._seal_all(
                    recs,
                    mid_hook=lambda: faults.corrupt_cache(
                        np.random.default_rng(5), target="const"))

        assert chaotic == clean                  # bit-exact through chaos
        snap = telemetry.snapshot()
        delta = {k: snap.get(k, 0) - before.get(k, 0)
                 for k in ("integrity_checks", "integrity_faults",
                           "resilience_quarantines", "resilience_retries",
                           "resilience_faults", "serve_completed")}
        assert delta["serve_completed"] == n
        assert delta["integrity_checks"] > 0
        assert delta["integrity_faults"] >= 1
        assert delta["resilience_quarantines"] >= 1
        fired = [s for s, _ in inj.injected if s == "program"]
        if fired:
            assert delta["resilience_faults"] >= len(fired)

    def test_tampered_tag_rejects_without_plaintext_leak(self):
        nonce, pt, aad = b"\x01" * 12, b"attack at dawn!!", b"hdr"
        sealed = gcm.aes128_gcm_seal(self.KEY, nonce, pt, aad,
                                     backend="einsum", device="cpu")
        tampered = sealed[:-1] + bytes([sealed[-1] ^ 1])
        with pytest.raises(gcm.InvalidTagError) as ei:
            gcm.aes128_gcm_open(self.KEY, nonce, tampered, aad,
                                backend="einsum", device="cpu")
        assert ei.value.indices == (0,)
        leak_surface = repr(ei.value) + repr(vars(ei.value))
        assert pt.decode() not in leak_surface
        assert pt.hex() not in leak_surface
