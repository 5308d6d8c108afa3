"""Batched serving engine: slot-based batching over a fixed decode batch.

Port of ``repro.serve.engine``, run eagerly.  The engine owns a fixed
batch of B slots; every decode step advances all slots in one call
(fixed shapes), each slot at the same position.  Prompts are consumed
token by token through the decode step, as in the reference.

Sampling: greedy or temperature.  With ``top_k`` the draw happens over
the (B, k) top-k value table and the sampled token id
(``token[b] = topk_ids[b, j_b]``) is fetched by one block-diagonal
crossbar gather over the whole batch — a
``plan_algebra.batched_gather_plan`` with B rows of one select — on the
exact integer path: one ``apply_plan`` per step.

Random draws come from a ``torch.Generator`` and do not reproduce
``jax.random``: greedy decoding matches the reference token for token,
sampled decoding only in shape and support.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._tree import leaves
from repro_torch.core import crossbar as xb
from repro_torch.core import moe_dispatch as md
from repro_torch.core import plan_algebra as pa
from repro_torch.core import telemetry


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    batch_slots: int = 8
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => full softmax
    eos_id: int = -1              # -1 => never stops early


def sample_token(logits: torch.Tensor, generator=None, *,
                 temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32.  Greedy takes the first maximum."""
    logits = logits.to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        vals, ids = md.top_k(logits, top_k)                  # (B, k) each
        j = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                              generator=generator)           # (B, 1)
        plan = pa.batched_gather_plan(j.to(torch.int32), top_k)
        token = xb.apply_plan(plan, ids.reshape(-1).to(torch.int32))
        return token.to(torch.int32)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0].to(torch.int32)


class ServingEngine:
    """Fixed-slot batching around a ``ModelAPI``."""

    def __init__(self, api, options: ServeOptions, *, max_seq: int,
                 cache_dtype=torch.float32):
        self.api = api
        self.opt = options
        self.max_seq = max_seq
        self._caches = api.init_caches(options.batch_slots, max_seq,
                                       cache_dtype)

    def _step(self, params, tokens1, pos, generator):
        # Serving never differentiates: parameters a trainer has set to
        # require grad build no autograd graph here.
        with torch.inference_mode():
            logits, self._caches = self.api.decode_fn(params, tokens1,
                                                      self._caches, pos)
        return sample_token(logits[:, -1], generator,
                            temperature=self.opt.temperature,
                            top_k=self.opt.top_k)

    @staticmethod
    def engine_telemetry() -> dict:
        """Crossbar pass and plan/schedule cache counters.  Eagerly, each
        decode step shows one dispatch and one combine pass per MoE layer,
        plus the sampled-token gather when ``top_k`` is set."""
        return telemetry.snapshot()

    def generate(self, params, prompts: list[list[int]], *,
                 generator=None) -> list[list[int]]:
        """Decode a batch of prompts (one admission).  Prompts are
        consumed through the decode step in lockstep; short prompts
        repeat their last token."""
        opt = self.opt
        b = opt.batch_slots
        if not prompts:
            raise ValueError("generate() needs at least one prompt "
                             "(got an empty prompt list)")
        if len(prompts) > b:
            raise ValueError(f"{len(prompts)} prompts for {b} slots")
        for i, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(
                    f"prompt {i} is empty — every prompt needs at least "
                    "one token (decode is teacher-forced from the first "
                    "token; there is no BOS injection here)")
        dev = self.api.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for c in leaves(self._caches):    # the initial caches, as in the
            c.zero_()                     # reference (nested for encdec)
        n = len(prompts)
        maxlen = max(len(p) for p in prompts)
        padded = np.zeros((b, maxlen), dtype=np.int32)
        padded[:n] = [p + [p[-1]] * (maxlen - len(p)) for p in prompts]
        columns = torch.as_tensor(padded, device=dev)
        tok = columns[:, :1]
        for pos in range(maxlen - 1):
            self._step(params, tok, pos, generator)
            tok = columns[:, pos + 1:pos + 2]
        outs: list[list[int]] = [[] for _ in prompts]
        done = np.zeros(n, dtype=bool)
        for t in range(opt.max_new_tokens):
            pos = maxlen - 1 + t
            if pos >= self.max_seq:
                break
            nxt = self._step(params, tok, pos, generator)
            nxt_np = nxt.cpu().numpy()
            for i in range(n):
                if not done[i]:
                    outs[i].append(int(nxt_np[i]))
                    if opt.eos_id >= 0 and nxt_np[i] == opt.eos_id:
                        done[i] = True
            if done.all():
                break
            tok = nxt[:, None]
        return outs
