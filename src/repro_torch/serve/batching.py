"""Continuous request batching over the fixed-latency crypto engine.

Port of ``repro.serve.batching``.
``serve/engine.py`` batches *tokens* for a model; this module batches
*requests* for the permutation engine's crypto workloads — many clients
submitting variable-length payloads to be hashed or sealed, served from
a bounded admission queue by a device-feed worker thread.  Every answer
is bit-exact or a clean typed rejection, never a hang.

* **Padded bucket shapes.**  SHA3-256 requests are bucketed by sponge
  geometry (``n_blocks`` of the rate), AES-128-GCM seal records
  (``op="gcm_seal"``) by (plaintext, AAD) length, and the batch axis is
  padded to the next power of two, so each bucket shape is one of a
  small fixed set and the fixed-latency contract
  (``StaticPlanRegistry.observe``) holds per bucket.

* **Admission control.**  Past ``max_queue`` pending requests ``submit``
  sheds load with a typed ``Overloaded``; per-request deadlines are
  enforced at dispatch (``TimeoutFault``), and queued requests can be
  cancelled.

* **Degradation.**  Each batch goes through
  ``resilience.ResilientExecutor`` down ``default_chain(device)``: on
  the card the plan-program megakernel first (one packed-layout launch
  a sponge block for SHA-3, one word-layout launch a batch for GCM),
  then the tile-skipping and the dense crossbar kernels; a batch all
  three failed completes with its typed fault (plain PyTorch never
  answers on the card).  Retries, fallbacks, breakers and quarantines
  are counted (``serve_*``, ``resilience_*``) and ``Request.backend``
  names the rung that answered.

* **Watchdog.**  The worker heartbeats through
  ``dist.fault.HeartbeatTracker`` (``check_workers``), and
  ``dist.fault.StragglerPolicy`` tracks batch wall times.

* **Double buffering.**  A prep thread pads and packs the next bucket
  (numpy only: it touches no CUDA tensor) while the feed thread's
  batch owns the card.  The feed thread passes the engine's device
  explicitly to every call, since the current CUDA device is per
  thread.

* **Mesh scale-out.**  With ``BatchingOptions(mesh=...)`` (a
  ``dist.mesh.Mesh``; shards may share a card) each padded SHA-3
  bucket's lane axis splits over the mesh's shards.  With
  ``partial_results`` (the default) every shard's lane window runs as
  its own journaled unit on its shard's device through the resilient
  chain — on the card one packed megakernel launch a shard and sponge
  block.  A shard whose every rung failed trips its device out of the
  mesh; the completed shards' lanes are kept (``ResultJournal``), only
  the lost window replays on a survivor, and later batches run on the
  survivor mesh ``dist.fault.survivor_mesh_shape`` gives.  Per-device
  health (``resilience.DeviceHealth``) is keyed by mesh index, never
  by ``torch.device``.  GCM seal buckets never shard.

* **Measured backend tuning.**  Every bucket execution records its wall
  time into a ``core.tuning.TuningTable`` keyed by (op, padded
  geometry).  Once the table has measured every rung of the chain for
  a bucket it rank-orders the chain measured-fastest-first; until then
  the configured order stands, so one fault on the head's first batch
  does not take the bucket off the head for good.  Each rung's run
  ends in the host copy of its digests or records, so that time
  includes the device's.

Synchronous use (tests, benchmarks) constructs the engine with
``start=False`` and calls ``run_once()`` to process one batch on the
caller's thread.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math
import queue as queue_mod
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch._device import resolve
from repro_torch.core import telemetry
from repro_torch.core.resilience import (DeviceHealth, Fault,
                                         ResilientExecutor, TimeoutFault,
                                         default_chain, is_build_failure)
from repro_torch.core.tuning import TuningTable
from repro_torch.crypto import gcm, keccak
from repro_torch.crypto.registry import registry
from repro_torch.dist import mesh_exec as mx
from repro_torch.dist.fault import (HeartbeatTracker, StragglerPolicy,
                                    survivor_mesh_shape)
from repro_torch.dist.mesh import Mesh

_RATE_BYTES = 136  # SHA3-256 sponge rate


class Overloaded(RuntimeError):
    """The admission queue is full; the request was shed, not queued."""


class Cancelled(RuntimeError):
    """The request was cancelled before execution."""


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

_SUPPORTED_OPS = ("sha3_256", "gcm_seal")


def _n_blocks(payload_len: int) -> int:
    """Sponge blocks absorbed for a payload of this length (pad10*1
    always appends at least the domain byte, so the count is exact)."""
    return (payload_len + 1 + _RATE_BYTES - 1) // _RATE_BYTES


def _dummy_payload(n_blocks: int) -> bytes:
    """A payload whose padded form occupies exactly ``n_blocks``."""
    return b"\x00" * (_RATE_BYTES * n_blocks - 1)


# AEAD records ride the same byte-payload admission path as digests.
# Wire format for op="gcm_seal": nonce(12) || aad_len:u32be || aad ||
# plaintext; the result is ciphertext || 16-byte tag.  The bucket key
# is the exact (pt_len, aad_len) record geometry — that is what one
# fused GCM program instance covers, so a bucket maps 1:1 onto ONE
# program launch with the batch as payload lanes.

def encode_aead_record(nonce: bytes, plaintext: bytes,
                       aad: bytes = b"") -> bytes:
    """Pack one seal request for ``submit(..., op='gcm_seal')``."""
    if len(nonce) != gcm.IV_BYTES:
        raise ValueError(f"AEAD nonce must be {gcm.IV_BYTES} bytes")
    return nonce + len(aad).to_bytes(4, "big") + aad + plaintext


def _decode_aead_record(payload: bytes) -> tuple:
    aad_len = int.from_bytes(payload[12:16], "big")
    return (payload[:12], payload[16 + aad_len:], payload[16:16 + aad_len])


def _aead_bucket(payload: bytes) -> tuple:
    aad_len = int.from_bytes(payload[12:16], "big")
    return (len(payload) - 16 - aad_len, aad_len)   # (pt_len, aad_len)


_RID_COUNTER = itertools.count(1)


class Request:
    """One submitted payload: a thread-safe future with a deadline."""

    __slots__ = ("op", "payload", "deadline", "backend", "_event", "_value",
                 "_exc", "_lock", "t_submit", "t_done", "trace_id", "rid")

    def __init__(self, payload: bytes, op: str,
                 deadline: Optional[float]):
        self.op = op
        self.payload = payload
        self.deadline = deadline
        # Process-unique request id: the key of the partial-batch
        # result journal (a replay needs an identity that survives
        # requeue and recovery, which list position does not).
        self.rid = next(_RID_COUNTER)
        self.backend: Optional[str] = None
        self._event = threading.Event()
        self._value: Optional[bytes] = None
        self._exc: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        # Request-scoped trace id: every span this request touches —
        # queue wait on the admission side, pack on the prep thread,
        # absorb on the device-feed thread — carries it, so a timeline
        # groups one request's whole lifecycle across threads.
        self.trace_id = _obs.new_trace_id() if _obs.enabled() else None

    @property
    def bucket(self) -> tuple:
        if self.op == "gcm_seal":
            return (self.op,) + _aead_bucket(self.payload)
        return (self.op, _n_blocks(len(self.payload)))

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    def _finish(self, *, value: Optional[bytes] = None,
                exc: Optional[BaseException] = None,
                backend: Optional[str] = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value, self._exc, self.backend = value, exc, backend
            self.t_done = time.perf_counter()
            self._event.set()
        # Retroactive lifecycle span (outside the lock): submit ->
        # completion, tagged with the terminal outcome.
        _obs.span_at("request", self.t_submit, self.t_done,
                     trace_id=self.trace_id, op=self.op,
                     outcome=("ok" if exc is None
                              else type(exc).__name__),
                     backend=backend or "")
        return True

    def cancel(self) -> bool:
        """Cancel a queued request; False if it already completed."""
        cancelled = self._finish(exc=Cancelled("request cancelled"))
        if cancelled:
            telemetry.incr("serve_cancelled")
        return cancelled

    def result(self, timeout: Optional[float] = None) -> bytes:
        """Block for the digest; raises the typed completion error."""
        if not self._event.wait(timeout):
            raise TimeoutFault(
                f"result not ready within {timeout}s (request still "
                "queued or executing)")
        if self._exc is not None:
            raise self._exc
        return self._value


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchingOptions:
    """Admission + execution knobs.

    ``chain=None`` resolves to ``resilience.default_chain(device)``
    (megakernel-first on the card, einsum-first on the CPU).
    ``fixed_latency=True`` runs every bucket under the crypto registry's
    observation contract; drift then surfaces as ``DriftFault`` and is
    quarantined rather than poisoning the pinned caches.
    """

    max_batch: int = 8
    max_queue: int = 1024
    default_timeout_s: Optional[float] = None
    poll_interval_s: float = 0.02
    fixed_latency: bool = True
    chain: Optional[tuple] = None
    watchdog_miss_threshold: int = 3
    batch_log_cap: int = 256
    # Mesh scale-out: a dist.mesh.Mesh shards each bucket's lane axis
    # over ``mesh_axis``; None keeps the single-device path.
    mesh: Optional[Mesh] = None
    mesh_axis: str = "data"
    # Overlap host-side packing with device absorb (threaded mode only;
    # run_once() stays synchronous regardless).
    double_buffer: bool = True
    # Measured backend table; None creates a fresh engine-local one.
    tuning: Optional[TuningTable] = None
    # Engine-held AES-128 key for op="gcm_seal" buckets (per-record
    # keys would defeat bucketing: the fused program is per-key).
    aead_key: bytes = b"\x00" * 16
    # Partial-batch recovery on a mesh: each shard's lane window runs
    # as its own journaled unit, so a device fault mid-batch keeps the
    # completed shards and replays only the lost lanes on the
    # survivors.  False runs the whole batch sharded at once.
    partial_results: bool = True
    # Result-journal capacity (completed lanes kept for idempotent
    # replay; the oldest entries age out).
    journal_cap: int = 4096

    def __post_init__(self):
        if self.mesh is not None and self.mesh_axis not in \
                self.mesh.axis_names:
            raise ValueError(f"mesh_axis {self.mesh_axis!r} not on mesh "
                             f"{tuple(self.mesh.axis_names)}")


class ResultJournal:
    """Completed-lane journal for partial-batch recovery.

    Maps request id -> result bytes for lanes whose shard completed, so
    a replay after a mid-batch device fault is idempotent: windows whose
    live lanes are all journaled are served from it, and a lane that
    replays anyway records the same bytes again.  Bounded (FIFO aging):
    a recovery scratchpad, not a cache.
    """

    def __init__(self, cap: int = 4096):
        if cap < 1:
            raise ValueError(f"journal cap must be >= 1, got {cap}")
        self.cap = cap
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()

    def record(self, rid: int, value: bytes) -> None:
        with self._lock:
            self._entries[rid] = value
            self._entries.move_to_end(rid)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)

    def get(self, rid: int) -> Optional[bytes]:
        with self._lock:
            return self._entries.get(rid)

    def forget(self, rid: int) -> None:
        with self._lock:
            self._entries.pop(rid, None)

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)


def _shard_probe(shard_index: int, device_index: int) -> None:
    """Per-shard dispatch hook, called just before a shard's lanes run
    on mesh index ``device_index``.  A no-op in production;
    ``core.faults.inject_device_fault`` patches this module attribute
    to kill a chosen shard mid-batch."""


def _staging_put(queue, item) -> None:
    """Staging-queue insertion hook (prep thread -> device feed).  A
    plain ``put`` in production; ``core.faults.inject_faults`` patches
    this module attribute to stall or drop prepared batches."""
    queue.put(item)


def _pack_blocks(payloads: Sequence[bytes]) -> np.ndarray:
    """Host-side half of a bucket execution: pad10*1 every payload and
    stack the full-state absorb blocks, (B, n_blocks, STATE_BITS) int32.

    Pure numpy so the prep thread can run it while the feed thread's
    previous batch still owns the device — the double-buffering split.
    """
    blocks = np.stack([keccak._pad101(m, _RATE_BYTES, 0x06)
                       for m in payloads])          # (B, n_blocks, rate bits)
    b, n_blocks = blocks.shape[:2]
    pad_tail = np.zeros((b, n_blocks, keccak.STATE_BITS - _RATE_BYTES * 8),
                        np.int32)
    return np.concatenate([blocks, pad_tail], axis=2)


def _absorb_digests(blocks: np.ndarray, backend: str, *,
                    fixed_latency: bool, device, mesh: Optional[Mesh] = None,
                    mesh_axis: str = "data") -> list:
    """Device-side half: sponge-absorb pre-packed blocks, one
    ``keccak_f1600`` per block with B as payload width, and squeeze the
    digests (bytes, after their copy to the host).

    The (B, n_blocks, 1600) blocks go to the device in one copy a batch
    (a shard), from pinned memory on the card, not one copy a block.
    With ``mesh`` set the lanes split over the shards along
    ``mesh_axis``, each absorbing its own lanes on its own device: every
    absorb step is elementwise across lanes, so nothing moves between
    shards.  The megakernel keeps the unsharded path on ``device``, as
    in the reference.
    """
    b, n_blocks = blocks.shape[:2]
    if mesh is not None and backend != "megakernel" and b > 1:
        devices = mesh.axis_devices(mesh_axis)
        bounds = mx.shard_bounds(b, len(devices))
    else:
        devices, bounds = [device], [(0, b)]
    bits = []
    for dev, (lo, hi) in zip(devices, bounds):
        host = torch.from_numpy(blocks[lo:hi])
        if dev.type == "cuda":
            host = host.pin_memory()
        dev_blocks = host.to(dev, non_blocking=True)
        states = torch.zeros((hi - lo, keccak.STATE_BITS), dtype=torch.int32,
                             device=dev)
        for i in range(n_blocks):
            states = states ^ dev_blocks[:, i]
            states = keccak.keccak_f1600(states, backend=backend,
                                         batch_mode="payload",
                                         fixed_latency=fixed_latency)
        bits.append(states[:, :256].to(torch.uint8).cpu().numpy())
    digests = np.packbits(np.concatenate(bits), axis=1, bitorder="little")
    return [d.tobytes() for d in digests]


def _bucket_digests(payloads: Sequence[bytes], backend: str, *,
                    fixed_latency: bool, device=None) -> list:
    """SHA3-256 of a padded bucket on one backend (ragged-capable).

    Unlike ``keccak.sha3_256_batched`` the lanes need not share a byte
    length — only a padded *block count* (the bucket invariant).  B
    rides as payload width (``batch_mode='payload'``), so the per-round
    plan is the single-state ρ∘π plan for every bucket width and the
    megakernel program handles the batch natively.
    """
    return _absorb_digests(_pack_blocks(payloads), backend,
                           fixed_latency=fixed_latency,
                           device=resolve(device))


def _keccak_registry_keys(backend: str) -> tuple:
    """The static-registry entries a bucket execution depends on —
    what drift quarantine must evict for the given backend."""
    if backend == "megakernel":
        return (keccak.MEGAKERNEL_PROGRAM_KEY,)
    return ("keccak/rho_pi",)


def _bucket_seal(payloads: Sequence[bytes], backend: str, key: bytes, *,
                 fixed_latency: bool, device) -> list:
    """Seal one AEAD bucket: decode the wire records and run the whole
    batch as ONE fused GCM program launch (backend='megakernel'), or the
    chained per-block lowering on a crossbar backend when degraded."""
    recs = [_decode_aead_record(p) for p in payloads]
    be = "fused" if backend == "megakernel" else backend
    return gcm.aes128_gcm_seal_batch(
        key, [r[0] for r in recs], [r[1] for r in recs],
        [r[2] for r in recs], backend=be,
        fixed_latency=fixed_latency and be == "fused", device=device)


def _gcm_registry_keys(key: bytes, pt_len: int, aad_len: int):
    """Quarantine targets for a gcm_seal bucket: the fused program on
    the megakernel rung, the GHASH plan on the chained rungs."""
    def keys(backend: str) -> tuple:
        if backend == "megakernel":
            return (gcm._program_key(key, pt_len, aad_len, False),)
        return (gcm._ghash_plan_key(gcm._hash_key(key), "horner", 1),)
    return keys


class BatchingEngine:
    """Bounded-queue continuous batching with graceful degradation.

    ``device=None`` means the card (and raises without one); the CPU is
    used only when asked for (``device="cpu"``), where the kernels run
    their plain versions.
    """

    def __init__(self, options: BatchingOptions = BatchingOptions(), *,
                 executor: Optional[ResilientExecutor] = None,
                 device=None, start: bool = True):
        self.opt = options
        self.device = resolve(device)
        self.chain = (tuple(options.chain) if options.chain is not None
                      else default_chain(self.device))
        self.executor = executor if executor is not None else (
            ResilientExecutor(chain=self.chain,
                              registry=registry(self.device)))
        self._queue: "collections.deque[Request]" = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._running = False
        self._worker: Optional[threading.Thread] = None
        self._prep: Optional[threading.Thread] = None
        # Double-buffer staging between the prep (pack/pad) thread and
        # the device-feed thread: depth 2 means the next bucket's host
        # work happens while the current batch owns the device.
        self._staging: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
        # Mesh state.  Shard d of the full mesh (its mesh index) runs on
        # ``_mesh_devices[d]``; DeviceHealth tracks a breaker per index,
        # and the active mesh is rebuilt from the survivors on demand.
        self.device_health: Optional[DeviceHealth] = None
        self._mesh: Optional[Mesh] = None
        self._mesh_devices: list = []
        self._survivor_cache: dict = {}
        if options.mesh is not None:
            self._mesh = Mesh(options.mesh.devices, options.mesh.axis_names)
            self._mesh_devices = list(self._mesh.devices.reshape(-1))
            self.device_health = DeviceHealth(len(self._mesh_devices))
        # Partial-batch recovery journal: completed lanes by request id.
        self.journal = ResultJournal(cap=options.journal_cap)
        # Measured backend tuning (core/tuning.py): records every bucket
        # wall time and rank-orders the fallback chain (_ranked_chain).
        self.tuning = options.tuning if options.tuning is not None \
            else TuningTable()
        # Worker watchdog + straggler tracking (the serving worker is
        # host 0 of a 1-host fleet).
        self.heartbeats = HeartbeatTracker(
            1, miss_threshold=options.watchdog_miss_threshold)
        self.straggler = StragglerPolicy()
        # Rolling ledger of executed buckets: (op, bucket_shape, backend,
        # live_requests) — tests and benchmarks read it.
        self.batch_log: "collections.deque[tuple]" = collections.deque(
            maxlen=options.batch_log_cap)
        # Export-time gauges, evaluated only when metrics are read; a
        # newer engine replaces an older one's registrations.
        _obs.metrics.gauge_fn("serve_queue_depth", self.queue_depth)
        _obs.metrics.gauge_fn(
            "resilience_breaker_open",
            lambda: len(self.executor.breaker.open_keys()))
        _obs.metrics.gauge_fn("serve_tuning_entries",
                              lambda: len(self.tuning))
        _obs.metrics.gauge_fn("serve_staging_depth",
                              self._staging.qsize)
        _obs.metrics.gauge_fn("serve_journal_depth", self.journal.depth)
        if self.device_health is not None:
            _obs.metrics.gauge_fn("serve_mesh_active", self._mesh_active)
            _obs.metrics.gauge_fn(
                "serve_mesh_lost", lambda: len(self.device_health.lost()))
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._running = True
        if self.opt.double_buffer:
            self._prep = threading.Thread(target=self._prep_loop,
                                          name="batching-host-prep",
                                          daemon=True)
            self._prep.start()
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="batching-device-feed",
                                        daemon=True)
        self._worker.start()

    def close(self, *, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop the worker(s).  ``drain=True`` finishes queued work first;
        otherwise pending requests complete with ``Cancelled``."""
        with self._work:
            if not drain:
                while self._queue:
                    self._queue.popleft().cancel()
            self._running = False
            self._work.notify_all()
        if self._prep is not None:
            self._prep.join(timeout)
            self._prep = None
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None

    def __enter__(self) -> "BatchingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=not any(exc))

    # -- admission ----------------------------------------------------------

    def submit(self, payload: bytes, *, op: str = "sha3_256",
               timeout_s: Optional[float] = None) -> Request:
        """Queue one payload; returns a ``Request`` future.

        Raises ``Overloaded`` when the bounded queue is full (load
        shedding — the caller should back off) and ``ValueError`` for
        unsupported ops.
        """
        if op not in _SUPPORTED_OPS:
            raise ValueError(f"unsupported op {op!r}; supported: "
                             f"{_SUPPORTED_OPS}")
        if timeout_s is None:
            timeout_s = self.opt.default_timeout_s
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        req = Request(bytes(payload), op, deadline)
        with self._work:
            if len(self._queue) >= self.opt.max_queue:
                telemetry.incr("serve_shed")
                raise Overloaded(
                    f"admission queue full ({self.opt.max_queue} pending); "
                    "request shed")
            self._queue.append(req)
            telemetry.incr("serve_admitted")
            self._work.notify()
        return req

    def map(self, payloads: Sequence[bytes], *, op: str = "sha3_256",
            timeout_s: Optional[float] = None) -> list:
        """Submit-and-wait convenience: results in input order."""
        reqs = [self.submit(p, op=op, timeout_s=timeout_s)
                for p in payloads]
        return [r.result() for r in reqs]

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- dispatch -----------------------------------------------------------

    def _take_batch_locked(self) -> tuple:
        """Pop one bucket-aligned batch; finish expired/cancelled inline.

        The oldest live request defines the bucket; up to ``max_batch``
        live requests sharing it are taken in FIFO order.  Returns
        ``(batch, rejected)``.
        """
        now = time.monotonic()
        batch: list = []
        rejected = 0
        bucket = None
        keep: list = []
        while self._queue:
            req = self._queue.popleft()
            if req.done():          # cancelled while queued
                rejected += 1
                continue
            if req.deadline is not None and now >= req.deadline:
                req._finish(exc=TimeoutFault(
                    f"deadline expired after {now - (req.deadline):.3f}s "
                    "in queue"))
                telemetry.incr("serve_timeouts")
                rejected += 1
                continue
            if bucket is None:
                bucket = req.bucket
            if req.bucket == bucket and len(batch) < self.opt.max_batch:
                batch.append(req)
            else:
                keep.append(req)
        self._queue.extend(keep)
        if batch and _obs.enabled():
            # Queue wait is only knowable retroactively: it spans the
            # admission thread's submit and THIS thread's take.
            t_take = time.perf_counter()
            for req in batch:
                _obs.span_at("queue_wait", req.t_submit, t_take,
                             trace_id=req.trace_id, op=req.op)
        return batch, rejected

    # -- mesh membership ----------------------------------------------------

    def report_device_fault(self, device: int) -> bool:
        """Feed one fault attributed to mesh index ``device`` into its
        breaker.  Returns True when this fault trips it out of the mesh;
        later batches rebuild onto the survivor mesh."""
        if self.device_health is None:
            raise ValueError("report_device_fault: engine has no mesh")
        tripped = self.device_health.record_failure(device)
        if tripped:
            telemetry.incr("serve_mesh_device_drops")
        return tripped

    def _active_mesh(self) -> Optional[Mesh]:
        """The mesh batches run on now: the full mesh, a survivor mesh
        of the healthy shards (its ``ids`` their full-mesh indices), or
        None (the single-device path) when none survives."""
        if self.device_health is None:
            return None
        lost = self.device_health.lost()
        if not lost:
            return self._mesh
        healthy = tuple(self.device_health.healthy())
        if healthy in self._survivor_cache:
            return self._survivor_cache[healthy]
        try:
            # survivor_mesh_shape shrinks by name; serving meshes are
            # 1-axis, so compute under "data" and relabel to our axis.
            shape = survivor_mesh_shape({"data": len(self._mesh_devices)},
                                        len(lost))
        except (ValueError, RuntimeError):
            telemetry.incr("serve_mesh_collapsed")
            self._survivor_cache[healthy] = None
            return None
        ids = healthy[:shape["data"]]
        mesh = Mesh([self._mesh_devices[d] for d in ids],
                    (self.opt.mesh_axis,), ids=np.asarray(ids))
        telemetry.incr("serve_mesh_rebuilds")
        self._survivor_cache[healthy] = mesh
        return mesh

    def _mesh_active(self) -> int:
        mesh = self._active_mesh()
        return 0 if mesh is None else mesh.size

    def _mesh_lane_floor(self) -> int:
        """Lane padding covers the FULL mesh, so any power-of-two
        survivor mesh still divides it."""
        return max(1, len(self._mesh_devices))

    def _prepare(self, batch: list) -> tuple:
        """Host half of a bucket execution: pow2 lane padding + payload
        packing (numpy only).  Runs on the prep thread when
        double-buffered."""
        bucket = batch[0].bucket
        op, geom = bucket[0], bucket[1:]
        # (b_pad, *geom) IS the geometry the fixed-latency contract and
        # the circuit breaker key on.  On a mesh the floor is the shard
        # count, so every shard gets lanes.
        b_pad = self._mesh_lane_floor()
        while b_pad < len(batch):
            b_pad *= 2
        payloads = [r.payload for r in batch]
        if op == "gcm_seal":
            pt_len, aad_len = geom
            filler = encode_aead_record(b"\x00" * gcm.IV_BYTES,
                                        b"\x00" * pt_len,
                                        b"\x00" * aad_len)
            payloads += [filler] * (b_pad - len(batch))
            telemetry.incr("serve_padded_lanes", b_pad - len(batch))
            # Records stay as wire bytes: the seal path owns its own
            # bit packing (gcm._pack_records) per backend.
            return op, geom, b_pad, payloads
        (n_blocks,) = geom
        payloads += [_dummy_payload(n_blocks)] * (b_pad - len(batch))
        telemetry.incr("serve_padded_lanes", b_pad - len(batch))
        with _obs.span("bucket_pack", trace_id=batch[0].trace_id, op=op,
                       n_blocks=n_blocks, lanes=len(batch), b_pad=b_pad):
            return op, geom, b_pad, _pack_blocks(payloads)

    def _execute_batch(self, batch: list,
                       prepared: Optional[tuple] = None) -> None:
        op, geom, b_pad, data = (prepared if prepared is not None
                                 else self._prepare(batch))
        shape = (b_pad,) + geom
        device = self.device
        mesh = self._active_mesh()
        mesh_shape = None if mesh is None else dict(mesh.shape)
        if (self.opt.partial_results and mesh is not None
                and op != "gcm_seal" and mesh.size > 1):
            # Per-shard journaled execution: a device fault mid-batch
            # loses one lane window, not the batch.  (gcm_seal keeps
            # the single-launch fused path: it never shards.)
            return self._execute_batch_partial(batch, op, geom, b_pad,
                                               data, mesh)
        if op == "gcm_seal":
            def run(backend: str) -> list:
                return _bucket_seal(data, backend, self.opt.aead_key,
                                    fixed_latency=self.opt.fixed_latency,
                                    device=device)
            registry_keys = _gcm_registry_keys(self.opt.aead_key, *geom)
        else:
            def run(backend: str) -> list:
                return _absorb_digests(data, backend,
                                       fixed_latency=self.opt.fixed_latency,
                                       device=device, mesh=mesh,
                                       mesh_axis=self.opt.mesh_axis)
            registry_keys = _keccak_registry_keys

        chain = self._ranked_chain(op, shape, mesh_shape)
        # The span IS the batch stopwatch: straggler tracking and the
        # tuning EWMA both read its duration (a disabled span still times
        # itself), and every run ends in its result's host copy, so the
        # device's time is inside it.
        sp = _obs.span("device_absorb", trace_id=batch[0].trace_id, op=op,
                       b_pad=b_pad, geom=str(geom), lanes=len(batch),
                       mesh=mesh is not None)
        try:
            with sp:
                res = self.executor.execute(
                    op, shape, run, chain=chain,
                    registry_keys=registry_keys)
                sp.set(backend=res.backend)
        except Exception as e:  # noqa: BLE001 — typed completion below
            # A typed fault after the chain gave up, or a build failure
            # (or missing card) that no rung may hide: every request of
            # the batch completes with it, never hangs.
            if not (isinstance(e, Fault) or is_build_failure(e)):
                raise
            telemetry.incr("serve_failed", len(batch))
            for req in batch:
                req._finish(exc=e)
            return
        finally:
            self.straggler.observe(sp.duration_s)
            telemetry.incr("serve_batches")
        self.tuning.record_span(sp, op, shape, res.backend,
                                mesh_shape=mesh_shape)
        if mesh is not None:
            telemetry.incr("serve_mesh_batches")
            # A successful mesh batch is a health signal for every shard
            # that took part (half-open probes rejoin here).
            for d in mesh.ids.reshape(-1):
                self.device_health.record_success(int(d))
        self.batch_log.append((op, shape, res.backend, len(batch)))
        telemetry.incr("serve_completed", len(batch))
        for req, value in zip(batch, res.value):
            req._finish(value=value, backend=res.backend)

    def _ranked_chain(self, op: str, shape: tuple,
                      mesh_shape: Optional[dict] = None) -> tuple:
        """The chain for a bucket: measured-fastest-first once the
        tuning table has measured every rung, else the configured
        order.  The engine records only the rung that answered, so a
        ranking of a partly measured chain would put a fallback that
        answered once ahead of an unmeasured head for good."""
        measured = self.tuning.lookup(op, shape, mesh_shape=mesh_shape)
        if all(b in measured for b in self.chain):
            return self.tuning.rank_chain(op, shape, self.chain,
                                          mesh_shape=mesh_shape)
        return self.chain

    # -- partial-batch recovery --------------------------------------------

    def _force_trip(self, device_index: int) -> None:
        """Take a shard out of the mesh NOW: a device-attributed fault
        mid-batch is definitive, not a strike toward a threshold."""
        while self.device_health.is_healthy(device_index):
            self.device_health.record_failure(device_index)
        telemetry.incr("serve_mesh_device_drops")

    def _run_shard(self, op: str, geom: tuple, window: np.ndarray,
                   shard_index: int, device_index: int):
        """Run one shard's lane window on mesh index ``device_index``'s
        device through the resilient chain; the ResilientResult."""
        device = self._mesh_devices[device_index]

        def run(backend: str) -> list:
            _shard_probe(shard_index, device_index)
            return _absorb_digests(window, backend,
                                   fixed_latency=self.opt.fixed_latency,
                                   device=device)

        shape = (window.shape[0],) + geom
        telemetry.incr("serve_shard_launches")
        return self.executor.execute(op, shape, run,
                                     chain=self._ranked_chain(op, shape),
                                     registry_keys=_keccak_registry_keys)

    @staticmethod
    def _device_of_fault(exc: BaseException) -> Optional[int]:
        """Walk the cause chain for a fault attributed to a mesh index."""
        seen = 0
        while exc is not None and seen < 16:
            device = getattr(exc, "device", None)
            if isinstance(device, int):
                return device
            exc = exc.__cause__ or exc.__context__
            seen += 1
        return None

    def _execute_batch_partial(self, batch: list, op: str, geom: tuple,
                               b_pad: int, data: np.ndarray,
                               mesh: Mesh) -> None:
        """Mesh execution with per-shard journaling and lost-lane replay.

        Each shard of the padded lane axis runs as its own resilient
        execution on its device.  A completed shard's real lanes finish
        (and journal) at once, whatever later shards do.  A shard whose
        chain gave up force-trips its device and queues only its window
        for replay on a surviving shard: idempotent (journaled lanes are
        served from the journal), deadline-aware (lanes that cannot make
        their deadline shed with ``Overloaded``), and geometry-stable
        (the replay window keeps the shard's shape).  A build failure
        or a missing card completes every unfinished request with it.
        """
        ids = [int(d) for d in mesh.ids.reshape(-1)]
        bounds = mx.shard_bounds(b_pad, len(ids))
        by_lane: list = list(batch) + [None] * (b_pad - len(batch))
        telemetry.incr("serve_partial_batches")
        sp = _obs.span("partial_batch", trace_id=batch[0].trace_id, op=op,
                       b_pad=b_pad, shards=len(ids), lanes=len(batch))
        backend_used = None
        lost: list = []
        last_fault: Optional[Fault] = None

        def finish_window(lo: int, hi: int, values: list,
                          backend: str) -> None:
            for lane in range(lo, hi):
                req = by_lane[lane]
                if req is None:
                    continue
                self.journal.record(req.rid, values[lane - lo])
                if req._finish(value=values[lane - lo], backend=backend):
                    telemetry.incr("serve_completed")

        try:
            with sp:
                for s, (lo, hi) in enumerate(bounds):
                    try:
                        res = self._run_shard(op, geom, data[lo:hi], s,
                                              ids[s])
                    except Fault as e:
                        at_fault = self._device_of_fault(e)
                        self._force_trip(at_fault if at_fault is not None
                                         else ids[s])
                        sp.event("shard_lost", shard=s, device=ids[s])
                        lost.append((s, lo, hi))
                        last_fault = e
                        continue
                    backend_used = backend_used or res.backend
                    self.device_health.record_success(ids[s])
                    finish_window(lo, hi, res.value, res.backend)
                if lost:
                    telemetry.incr("serve_shards_salvaged",
                                   len(bounds) - len(lost))
                    self._replay_lost(op, geom, data, by_lane, lost,
                                      last_fault, sp)
        except Exception as e:  # noqa: BLE001 — typed completion below
            if not is_build_failure(e):
                raise
            for req in batch:
                if req._finish(exc=e):
                    telemetry.incr("serve_failed")
            return
        finally:
            # Its duration is the whole batch (salvage + any replay),
            # which is what the straggler EWMA should see.
            self.straggler.observe(sp.duration_s)
            telemetry.incr("serve_batches")
        telemetry.incr("serve_mesh_batches")
        self.batch_log.append((op, (b_pad,) + geom,
                               backend_used or "replay", len(batch)))

    def _replay_lost(self, op: str, geom: tuple, data: np.ndarray,
                     by_lane: list, lost: list,
                     last_fault: Optional[Fault], sp) -> None:
        """Replay only the lost shards' lane windows on the survivors."""
        survivors = self.device_health.healthy()
        if not survivors:
            telemetry.incr("serve_mesh_collapsed")
            for s, lo, hi in lost:
                for lane in range(lo, hi):
                    req = by_lane[lane]
                    if req is not None:
                        telemetry.incr("serve_failed")
                        req._finish(exc=last_fault)
            return
        # Deadline-aware resubmission: the straggler EWMA (scaled by its
        # deadline factor) estimates one replay window's wall time;
        # lanes that cannot make their deadline shed NOW with Overloaded
        # instead of spending survivor capacity.
        est_s = self.straggler.deadline
        now = time.monotonic()
        for s, lo, hi in lost:
            for lane in range(lo, hi):
                req = by_lane[lane]
                if req is None or req.deadline is None:
                    continue
                if now >= req.deadline or (math.isfinite(est_s)
                                           and now + est_s > req.deadline):
                    if req._finish(exc=Overloaded(
                            "survivor mesh cannot absorb the replay "
                            "before this request's deadline")):
                        telemetry.incr("serve_shed")
                        by_lane[lane] = None
        rr = itertools.cycle(survivors)
        for s, lo, hi in lost:
            live = [lane for lane in range(lo, hi)
                    if by_lane[lane] is not None
                    and not by_lane[lane].done()]
            if not live:
                continue  # nothing real in this window survived
            # Idempotent replay: a window whose live lanes all have
            # journaled results is served from the journal.
            pending = [lane for lane in live
                       if self.journal.get(by_lane[lane].rid) is None]
            if not pending:
                for lane in live:
                    req = by_lane[lane]
                    if req._finish(value=self.journal.get(req.rid),
                                   backend="journal"):
                        telemetry.incr("serve_completed")
                continue
            device_index = next(rr)
            try:
                res = self._run_shard(op, geom, data[lo:hi], s,
                                      device_index)
            except Fault as e:
                at_fault = self._device_of_fault(e)
                self._force_trip(at_fault if at_fault is not None
                                 else device_index)
                sp.event("replay_lost", shard=s, device=device_index)
                for lane in live:
                    telemetry.incr("serve_failed")
                    by_lane[lane]._finish(exc=e)
                continue
            telemetry.incr("lanes_replayed", len(live))
            sp.event("replayed", shard=s, lanes=len(live),
                     device=device_index)
            self.device_health.record_success(device_index)
            for lane in live:
                req = by_lane[lane]
                self.journal.record(req.rid, res.value[lane - lo])
                if req._finish(value=res.value[lane - lo],
                               backend=res.backend):
                    telemetry.incr("serve_completed")

    def run_once(self) -> int:
        """Process one batch synchronously (deterministic test hook).

        Returns the number of requests removed from the queue (completed,
        timed out, or skipped-as-cancelled); 0 means the queue was empty.
        """
        with self._lock:
            batch, rejected = self._take_batch_locked()
        if batch:
            self._execute_batch(batch)
        return len(batch) + rejected

    def _prep_loop(self) -> None:
        """Double-buffer producer: pack/pad the next bucket while the
        feed thread's current batch still owns the device.  The bounded
        staging queue (depth 2) provides the backpressure."""
        while True:
            with self._work:
                while self._running and not self._queue:
                    self._work.wait(self.opt.poll_interval_s)
                if not self._running and not self._queue:
                    break
                batch, _ = self._take_batch_locked()
            if batch:
                try:
                    _staging_put(self._staging,
                                 (batch, self._prepare(batch)))
                except Exception:  # noqa: BLE001 — staging drop/chaos
                    # A dropped staging put must not lose requests: the
                    # batch goes back to the FRONT of the admission
                    # queue (it still holds the oldest requests) and is
                    # re-taken — and re-prepared — on the next pass.
                    telemetry.incr("serve_staging_drops")
                    with self._work:
                        self._queue.extendleft(reversed(batch))
                        self._work.notify()
        self._staging.put(None)  # sentinel: feed thread drains then exits

    def _worker_loop(self) -> None:
        if self.opt.double_buffer:
            while True:
                try:
                    item = self._staging.get(
                        timeout=self.opt.poll_interval_s)
                except queue_mod.Empty:
                    self.heartbeats.beat(0)
                    continue
                if item is None:
                    return
                batch, prepared = item
                self.heartbeats.beat(0)
                self._execute_batch(batch, prepared)
        while True:
            with self._work:
                while self._running and not self._queue:
                    self._work.wait(self.opt.poll_interval_s)
                if not self._running and not self._queue:
                    return
                batch, _ = self._take_batch_locked()
            self.heartbeats.beat(0)
            if batch:
                self._execute_batch(batch)

    # -- supervision --------------------------------------------------------

    def check_workers(self) -> list:
        """Watchdog tick: hosts at/over the miss threshold (the worker
        beats once per dispatched batch/poll).  A returned ``[0]`` means
        the device feed is wedged."""
        missed = self.heartbeats.tick()
        if missed:
            telemetry.incr("serve_watchdog_misses")
        return missed

    def stats(self) -> dict:
        """Queue/telemetry/breaker snapshot for dashboards and tests."""
        snap = telemetry.snapshot()
        out = {k: v for k, v in snap.items()
               if k.startswith(("serve_", "resilience_"))}
        out["queue_depth"] = self.queue_depth()
        out["breaker_open"] = [
            list(map(str, k)) for k in self.executor.breaker.open_keys()]
        out["straggler_deadline_s"] = self.straggler.deadline
        out["tuning_entries"] = len(self.tuning)
        out["journal_depth"] = self.journal.depth()
        if self.device_health is not None:
            out["mesh_devices"] = len(self._mesh_devices)
            out["mesh_active"] = self._mesh_active()
            out["mesh_lost"] = self.device_health.lost()
        return out
