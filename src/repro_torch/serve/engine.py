"""Batched serving engine (counterpart of `repro.serve.engine`).

Drives a `repro_torch.models.LM` through prefill → decode with a shared
batched cache. Requests are left-padded into fixed (batch, max_len) slots
— continuous batching at the slot level: when a request finishes
mid-wave its slot is freed (`free_slots`) and refilled from the queue by
prefilling the new prompt alone and writing its cache row into the
batched cache, so the wave keeps decoding at full width instead of
draining to its slowest member. Sampling: greedy or temperature, per row.

Left padding is with token 0 and is not masked: positions count from the
pad, as the reference's do, so the two give the same answers.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.device import resolve_device


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, batch_size: int, max_len: int, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine "
                             f"on {self.device}")
        self.model = model
        self.batch_size = batch_size
        self.max_len = max_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # slot indices currently free inside the active wave (refillable)
        self.free_slots: List[int] = []
        self.refill_count = 0  # requests served via mid-wave slot reuse

    def _sample(self, logits: torch.Tensor, temperatures: np.ndarray) -> torch.Tensor:
        """Per-request sampling: greedy rows (temp ≤ 0) and temperature rows
        coexist in one wave; a temperature row takes the Gumbel-max of
        logits / temp with noise from the engine's generator."""
        greedy = torch.argmax(logits, dim=-1)
        if (temperatures <= 0).all():
            return greedy
        temps = torch.as_tensor(np.maximum(temperatures, 1e-6),
                                dtype=logits.dtype, device=logits.device)
        u = torch.rand(logits.shape, generator=self.gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        sampled = torch.argmax(logits / temps[:, None] + gumbel, dim=-1)
        is_greedy = torch.as_tensor(temperatures <= 0, device=logits.device)
        return torch.where(is_greedy, greedy, sampled)

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests; waves refill freed slots from the queue."""
        queue: Deque[Request] = deque(requests)
        while queue:
            wave = [queue.popleft()
                    for _ in range(min(self.batch_size, len(queue)))]
            self._run_wave(wave, queue)
        return requests

    def _left_pad(self, prompts: List[List[int]], width: int) -> torch.Tensor:
        tokens = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, width - len(p):] = p
        return torch.as_tensor(tokens).to(self.device)

    def _can_refill(self, req: Request, pos: int) -> bool:
        """A queued request fits the running wave iff its prompt left-pads
        to the wave's current position and its decode budget fits the
        remaining cache length."""
        return (len(req.prompt) <= pos
                and pos + req.max_new_tokens <= self.max_len)

    def _refill_slot(self, cache: list, slot: int, req: Request, pos: int):
        """Prefill `req` alone (left-padded to the wave position) and write
        its cache row into the batched cache at `slot` (one row write per
        layer tensor; the batch is axis 0 of each)."""
        tokens = self._left_pad([req.prompt], pos)
        with record_function("serve/engine/refill_prefill"):
            logits1, cache1 = self.model.prefill({"tokens": tokens},
                                                 max_len=self.max_len)
        for layer, layer1 in zip(cache, cache1):
            for name, t in layer.items():
                t[slot] = layer1[name][0]
        first = self._sample(logits1, np.array([req.temperature], np.float32))
        self.refill_count += 1
        return cache, int(first[0])

    def _run_wave(self, wave: List[Request], queue: Optional[Deque[Request]] = None):
        prompt_len = max(len(r.prompt) for r in wave)
        batch = {"tokens": self._left_pad([r.prompt for r in wave], prompt_len)}
        with record_function("serve/engine/prefill"):
            logits, cache = self.model.prefill(batch, max_len=self.max_len)
        slots: List[Optional[Request]] = list(wave)
        temperatures = np.array([r.temperature for r in wave], np.float32)
        next_tok = self._sample(logits, temperatures)
        for r, t in zip(slots, next_tok.tolist()):
            r.out_tokens.append(t)
        pos = prompt_len
        self.free_slots = []
        while True:
            # retire finished requests → their slots become refillable
            for i, r in enumerate(slots):
                if r is not None and len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
                    slots[i] = None
                    self.free_slots.append(i)
            # mid-wave refill: freed slots pick up queued requests that fit
            while (queue and self.free_slots
                   and self._can_refill(queue[0], pos)):
                slot = self.free_slots.pop(0)
                req = queue.popleft()
                cache, first = self._refill_slot(cache, slot, req, pos)
                req.out_tokens.append(first)
                temperatures[slot] = req.temperature
                next_tok[slot] = first
                slots[slot] = req
            if all(r is None for r in slots):
                break  # wave drained (leftover queue starts a fresh wave)
            if pos >= self.max_len:
                # cache exhausted: truncate the stragglers at max_len
                for r in slots:
                    if r is not None:
                        r.done = True
                break
            with record_function("serve/engine/decode"):
                logits, cache = self.model.decode_step(cache, next_tok[:, None],
                                                       pos)
            next_tok = self._sample(logits, temperatures)
            pos += 1
            for i, (r, t) in enumerate(zip(slots, next_tok.tolist())):
                if r is not None and len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(t)
        self.free_slots = []
