"""Training loop: microbatched train_step builder + checkpointed Trainer.

Port of ``repro.train.trainer``.  ``make_train_step`` builds

    (state, batch) -> (state', metrics)

gradients by ``torch.autograd`` through ``loss_fn``, with gradient
accumulation over ``grad_accum`` microbatches: microbatch gradients are
summed in float32 and divided by n, as the reference's scan does.  Then
one AdamW update with the step's learning rate.

The Trainer composes the deterministic data pipeline (cursor = step),
async atomic checkpointing and exact resume.  A step updates the
parameters and moments of the state it is given in place, as the
reference's trainer donates its state buffers to the jitted step.
``TrainOptions.compress_grads`` and ``scan_unroll`` are carried for the
reference's option set and read by nothing here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import _tree
from repro_torch.optim import adamw_init, adamw_update, make_schedule


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    grad_accum: int = 1
    b1: float = 0.9
    b2: float = 0.95
    schedule: str = "cosine"      # cosine | wsd
    compress_grads: bool = False  # int8 + error feedback (not read here)
    scan_unroll: bool = False     # reference's accum-scan unroll (not read)
    bf16_params: bool = False     # live params bf16, f32 master in opt state


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    step: torch.Tensor            # () int64 on the host
    rng: torch.Tensor             # a CPU torch.Generator's state (uint8)


def _rng_state(seed: int) -> torch.Tensor:
    return torch.Generator().manual_seed(seed).get_state()


def _advance_rng(state: torch.Tensor) -> torch.Tensor:
    """The next step's generator state: one draw further (the reference
    folds the step into its key)."""
    g = torch.Generator()
    g.set_state(state)
    torch.randint(0, 2, (1,), generator=g)
    return g.get_state()


def init_state(params, seed: int = 0, *,
               bf16_params: bool = False) -> TrainState:
    """Fresh training state around ``params`` (zero moments, step 0, the
    generator state of ``seed``).  With ``bf16_params`` the live
    parameters are cast to bf16 and a float32 master of them rides in
    the optimizer state."""
    if bf16_params:
        live = _tree.tree_map(
            lambda p: p.detach().to(torch.bfloat16)
            if p.dtype.is_floating_point else p, params)
        return TrainState(params=live,
                          opt=adamw_init(live, keep_master=True),
                          step=torch.zeros((), dtype=torch.int64),
                          rng=_rng_state(seed))
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int64),
                      rng=_rng_state(seed))


def _split_microbatches(batch, n):
    """{name: (B, ...)} -> n microbatches {name: (B/n, ...)}."""
    out = [dict() for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by accum {n}")
        for i, part in enumerate(x.reshape((n, b // n) + tuple(x.shape[1:]))):
            out[i][k] = part
    return out


def _trainable(params) -> list:
    """The leaves of ``params``, each set to require grad (every leaf of
    a model's parameter tree is floating)."""
    leaves = _tree.leaves(params)
    for p in leaves:
        if not p.dtype.is_floating_point:
            raise ValueError(f"parameter leaf of dtype {p.dtype} cannot "
                             "be trained")
        if not p.requires_grad:
            p.requires_grad_(True)
    return leaves


def make_train_step(loss_fn: Callable, options: TrainOptions, *,
                    grad_hook: Optional[Callable] = None):
    """loss_fn(params, batch) -> (loss, metrics dict of 0-d tensors).

    ``grad_hook(params, grads)``, when given, sees the step's (averaged,
    unclipped) gradient tree before the update; it must not keep it.
    """
    schedule = make_schedule(options.schedule, peak_lr=options.peak_lr,
                             warmup_steps=options.warmup_steps,
                             total_steps=options.total_steps)

    def grads_of(params, leaves, batch):
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        leaves = _trainable(state.params)
        n = options.grad_accum
        if n > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in leaves]
            lsum = None
            per_mb = []
            for mb in _split_microbatches(batch, n):
                loss, metrics, g = grads_of(state.params, leaves, mb)
                gsum = [a + b_.to(torch.float32) for a, b_ in zip(gsum, g)]
                del g
                lsum = loss if lsum is None else lsum + loss
                per_mb.append(metrics)
            grads = [g / n for g in gsum]
            del gsum
            loss = lsum / n
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_mb]))
                       for k in per_mb[0]}
        else:
            loss, metrics, grads = grads_of(state.params, leaves, batch)
        grads = _tree.unflatten(state.params, grads)
        if grad_hook is not None:
            grad_hook(state.params, grads)

        lr = schedule(int(state.step))
        params, opt, optm = adamw_update(
            state.params, grads, state.opt, lr,
            b1=options.b1, b2=options.b2,
            weight_decay=options.weight_decay,
            max_grad_norm=options.max_grad_norm)
        del grads
        new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                               rng=_advance_rng(state.rng))
        metrics = {**metrics, **optm, "loss": loss, "lr": lr}
        return new_state, metrics

    return train_step


class Trainer:
    """Checkpointed training loop on the API's device."""

    def __init__(self, api, options: TrainOptions, *, pipeline,
                 ckpt_dir: str | None = None, keep: int = 3):
        self.api = api
        self.options = options
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.manager = None
        if ckpt_dir:
            from repro_torch.checkpoint import CheckpointManager
            self.manager = CheckpointManager(ckpt_dir, keep=keep)
        self.train_step = make_train_step(self.api.loss_fn, options)

    def init_or_restore(self, seed: int = 0) -> TrainState:
        """Parameters drawn from a generator seeded with ``seed`` on the
        API's device, or the latest checkpoint's state when there is
        one."""
        gen = torch.Generator(device=self.api.device).manual_seed(seed)
        params = self.api.init(gen)
        state = init_state(params, seed,
                           bf16_params=self.options.bf16_params)
        if self.manager and self.manager.latest_step() is not None:
            from repro_torch.checkpoint import restore
            state, _, _ = restore(self.ckpt_dir, state)
        return state

    def run(self, state: TrainState, *, steps: int,
            ckpt_every: int = 0, log_every: int = 10,
            log_fn=print) -> tuple[TrainState, list[dict]]:
        history = []
        dev = self.api.device
        for _ in range(steps):
            step_no = int(state.step)
            batch = {k: v.to(dev) for k, v in
                     self.pipeline.batch(step_no).items()}  # cursor == step
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time.perf_counter() - t0
            metrics["step"] = step_no
            history.append(metrics)
            if log_every and step_no % log_every == 0:
                log_fn(f"step {step_no:6d} loss {metrics['loss']:.4f} "
                       f"lr {metrics['lr']:.2e} "
                       f"({metrics['step_time_s']*1e3:.0f} ms)")
            if self.manager and ckpt_every and (step_no + 1) % ckpt_every == 0:
                self.manager.save_async(state, step_no + 1)
        if self.manager:
            self.manager.wait()
        return state, history
