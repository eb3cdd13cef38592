"""Host-loop serving engine.  Counterpart of ``repro/serve/host_loop.py``.

The slot-based continuous-batching engine the device engine
(``serve/engine.py``) replaced: requests are prefilled one at a time into
a free slot, all active slots decode together, and every sampled token
goes to the host (one device-to-host read per active slot per step) and
is sampled in numpy.

It is kept as (a) the differential-testing oracle of ``Engine``: greedy
outputs must match it, bit for bit on the CPU in float32; and (b) the
baseline the engine is measured against (``chip_smoke.py`` phase 12).
``stats["host_syncs"]`` counts the per-token device reads the engine
eliminates.

The reference's two historical fixes are kept:
  * a ``max_new=1`` request used to be admitted with ``remaining=0``; the
    decode loop skipped the slot without ever freeing it, so ``run()``
    spun forever.  Exhausted budgets free the slot at admit time.
  * ``run()`` used to snapshot the queue at entry, silently dropping
    requests admitted before the call.  Completions are tracked in a dict
    keyed at admit time.

Stochastic tokens take Gumbel noise from a numpy generator seeded with
``seed``; the JAX package draws from a threefry key, so only greedy
streams compare across the packages.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serve.engine import (StepBudgetExceeded, require_token_input,
                                     require_whole_params)
from repro_torch.serve.scheduler import Request


class HostLoopEngine:
    """Serves requests through ``model`` (``models.transformer.Model``) on
    the model's device, ``max_batch`` slots of ``cache_len`` positions."""

    def __init__(self, model, max_batch: int = 4, cache_len: int = 128,
                 seed: int = 0):
        require_token_input(model.arch, "the host loop")
        require_whole_params(model, "the host loop")
        self.model = model
        self.device = model.device
        self.B = max_batch
        self.S = cache_len
        self.rng = np.random.default_rng(seed)
        self.cache = model.init_cache(max_batch, cache_len)
        self.pos = np.zeros((max_batch,), np.int64)
        self.active: List[Optional[Request]] = [None] * max_batch
        self.remaining = np.zeros((max_batch,), np.int32)
        self.last_token = np.zeros((max_batch,), np.int32)
        self.queue: deque = deque()
        self.results: Dict[int, List[int]] = {}   # keyed at admit time
        self.stats: Dict[str, int] = dict(host_syncs=0, decode_steps=0)
        self.ttft: Dict[int, float] = {}

    # -- queue ------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            raise ValueError(f"req {req.uid}: max_new must be >= 1")
        if len(req.prompt) + req.max_new > self.S:
            raise ValueError(f"req {req.uid}: prompt + max_new exceeds "
                             f"cache_len ({self.S})")
        req.out_tokens = []
        req.submit_time = time.monotonic()
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _admit(self) -> None:
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                return
            req = self.queue.popleft()
            T = len(req.prompt)
            toks = torch.as_tensor(np.asarray(req.prompt, np.int64)[None],
                                   device=self.device)
            logits, cache1 = self.model.prefill(toks, self.S)
            # the single-request cache into this slot: prelude leaves have
            # the batch at axis 0, stacked block leaves after the (reps,)
            # axis; attention leaves come padded to cache_len and a Mamba
            # layer's (conv window, SSM state) whole, so every leaf of the
            # slot is written
            for cb, c1 in zip(self.cache["prelude"], cache1["prelude"]):
                for dst, src in zip(cb, c1):
                    dst[slot] = src[0]
            if self.cache["blocks"] is not None:
                for cb, c1 in zip(self.cache["blocks"], cache1["blocks"]):
                    for dst, src in zip(cb, c1):
                        dst[:, slot] = src[:, 0]
            tok = self._sample(logits[0, -1], req.temperature)
            req.out_tokens.append(tok)
            self.results[req.uid] = req.out_tokens
            self.ttft[req.uid] = time.monotonic() - req.submit_time
            if req.max_new <= 1:
                continue        # budget already spent: free the slot now
            self.active[slot] = req
            self.pos[slot] = T
            self.remaining[slot] = req.max_new - 1
            self.last_token[slot] = tok

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        """One token from one slot's (Vpad,) logits, on the host."""
        vocab = self.model.arch.vocab
        self.stats["host_syncs"] += 1
        lg = logits.float().cpu().numpy()[:vocab]
        if temperature <= 0:
            return int(np.argmax(lg))
        return int(np.argmax(lg / temperature + self.rng.gumbel(size=vocab)))

    # -- main loop ----------------------------------------------------------
    def step(self) -> None:
        """One decode step across all slots (the free ones decode too, and
        their writes are overwritten at their next admission)."""
        toks = torch.as_tensor(self.last_token[:, None].astype(np.int64),
                               device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        logits, self.cache = self.model.decode_step(self.cache, toks, pos)
        self.stats["decode_steps"] += 1
        for i, req in enumerate(self.active):
            if req is None or self.remaining[i] <= 0:
                continue
            tok = self._sample(logits[i, 0], req.temperature)
            req.out_tokens.append(tok)
            self.last_token[i] = tok
            self.pos[i] += 1
            self.remaining[i] -= 1
            if self.remaining[i] == 0:
                self.active[i] = None           # slot freed for the queue

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Serve everything submitted (and everything already admitted).
        Returns {uid: tokens}; a ``max_steps`` overrun raises
        ``StepBudgetExceeded`` with the finished and partial streams."""
        start_steps = self.stats["decode_steps"]   # budget is per call
        self._admit()
        while any(r is not None for r in self.active) or self.queue:
            if (max_steps is not None
                    and self.stats["decode_steps"] - start_steps >= max_steps):
                raise StepBudgetExceeded(
                    f"host-loop engine exceeded max_steps={max_steps} "
                    f"({len(self.results)} partial/completed outputs "
                    f"attached)",
                    {uid: list(toks) for uid, toks in self.results.items()})
            self.step()
            self._admit()
        done, self.results = self.results, {}
        return done
