"""Batched decode serving engine with continuous batching (slot refill).

A port of :mod:`repro.serve.engine`.  A fixed number of batch slots share
one decode step; a finished request frees its slot, which the next queued
request takes.  Prompts are teacher-forced through ``decode_step`` token
by token, and the next token is the greedy argmax.  As in the JAX package,
a refilled slot's cache is not reset: the new request continues from the
state its slot's previous request left (the RWKV / SSM state; for Zamba2,
the transformers and whisper the key/value entries and the length ``len``
that every slot shares, so a slot's request sees its predecessor's keys
and the ring buffer of a windowed model wraps at the shared length).
Every family is served unchanged, with the JAX engine's two other
behaviours: whisper's cross-attention cache is never filled (the requests
attend to zeros there), and a MoE decode step routes the slots as one
token group, so a request's tokens depend on its neighbours once an
expert's capacity is full.  Runs on the card unless ``device`` names
another; the step runs eagerly (no graph capture).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.api import ModelConfig, get_family


@dataclasses.dataclass
class Request:
    """One generation request: prompt tokens in, greedy tokens out."""

    rid: int
    prompt: list
    max_new_tokens: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Continuous-batching greedy decoder over ``slots`` batch rows."""

    def __init__(self, cfg: ModelConfig, params, slots: int = 4, max_len: int = 512, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        p_dev = next(params.parameters()).device
        if p_dev.type != self.device.type:
            raise ValueError(f"parameters are on {p_dev}, the engine on {self.device}")
        self.fam = get_family(cfg)
        self.slots = slots
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * slots
        self.cache = self.fam.init_cache(cfg, slots, max_len, device=self.device)
        self.tokens = np.zeros((slots, 1), np.int64)
        self._pending_prefill: List[deque] = [deque() for _ in range(slots)]

    def submit(self, req: Request) -> None:
        """Queue a request; it takes the next free slot."""
        self.queue.append(req)

    def _refill(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self._pending_prefill[s] = deque(req.prompt)
                self.tokens[s, 0] = self._pending_prefill[s].popleft()

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine tick: advances every active slot by one token."""
        self._refill()
        if all(a is None for a in self.active):
            return False
        tokens = torch.from_numpy(self.tokens).to(self.device)
        logits, self.cache = self.fam.decode_step(self.cfg, self.params, self.cache, tokens)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            if self._pending_prefill[s]:
                # still prefilling: feed the next prompt token, ignore the sample
                self.tokens[s, 0] = self._pending_prefill[s].popleft()
                continue
            req.out.append(int(nxt[s]))
            self.tokens[s, 0] = int(nxt[s])
            if len(req.out) >= req.max_new_tokens:
                req.done = True
                self.active[s] = None
        return True

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        """Step until the queue and every slot are empty; returns the ticks."""
        ticks = 0
        while (self.queue or any(self.active)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
