"""Continuous-batching serving engine on the device.  Counterpart of
``repro/serve/engine.py``.

All per-slot decode state stays on the device — last tokens, write
positions, per-slot temperatures, remaining budgets, the KV cache and the
emitted-token buffer — in the dict ``self.dev``.  The JAX version's jitted
closures are plain methods here and its ``lax.scan`` over decode steps is
a Python loop that never reads the device: sampling (``sampling.py``) runs
on the device, finished slots are live-masked, and the host learns of
completions from the scheduler's bookkeeping (``scheduler.py``), fetching
the output buffer once per completion event.

Admission is a batched prefill wave of the queued requests that fit the
free slots, right-padded to a shared length.  An architecture with Mamba
layers admits equal-length waves only, unpadded: a recurrent state would
absorb pad tokens (``has_mamba``, the scheduler's ``same_length_waves``).
``paged=True`` replaces the
per-slot cache slabs with a shared block pool and per-slot block tables
(``paging.py``); greedy outputs equal the contiguous engine's.  ``ledger``
attaches a per-user privacy-budget ledger (``ledger.py``).  The engines
serve token ids only, as the JAX engine does: an embedding-input arch
(``embed_stub``) is refused at construction (``require_token_input``) and
serves through ``Model.prefill`` and ``decode_step`` fed its embeddings.

Differences from the JAX engine: cache and state writes are IN PLACE (the
JAX version donates its buffers to each jitted call instead); a wave
prefills only its own rows, so the JAX version's dropped padding rows
(slot index ``B``) do not exist here and every scatter index is real; and
a slot's cache past its prompt keeps what an earlier occupant left there,
which the causal mask removes exactly as it removes the zeros the JAX
engine writes (the paged pool reuses blocks unzeroed in both packages).
The host-loop reference engine is ``host_loop.py``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import MAMBA
from repro_torch.serve.ledger import BudgetExceeded, PrivacyLedger, RequestCharge
from repro_torch.serve.paging import BlockPool, blocks_for
from repro_torch.serve.sampling import mask_padded_vocab, sample_tokens
from repro_torch.serve.scheduler import Request, Scheduler


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def require_token_input(arch, what: str) -> None:
    """Raise for an embedding-input arch: ``what`` drives token-input archs
    (the JAX engine and launcher take token ids only)."""
    if arch.embed_stub:
        raise ValueError(f"{arch.name}: {what} drives token-input archs (an "
                         f"embedding-input model serves through Model.prefill "
                         f"and decode_step fed its embeddings)")


def require_whole_params(model, what: str) -> None:
    """Raise for a model whose params are FSDP-sharded or tensor-parallel
    slices: ``what`` decodes, and decoding sliced params is not ported
    (ROADMAP queue 1)."""
    if hasattr(model, "_whole_params"):
        model._whole_params(what)


class StepBudgetExceeded(RuntimeError):
    """``run(max_steps=...)`` overran its budget.  ``results`` carries
    every output completed before the overrun."""

    def __init__(self, msg: str, results: Dict[int, List[int]]):
        super().__init__(msg)
        self.results = dict(results)


class Engine:
    """Serves requests through ``model`` (``models.transformer.Model``) on
    the model's device."""

    def __init__(self, model, max_batch: int = 4, cache_len: int = 128,
                 seed: int = 0, policy: str = "fifo", decode_chunk: int = 16,
                 prefill_chunk: int = 16, record_ttft: bool = False,
                 clock=time.monotonic, paged: bool = False,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_sharing: bool = True,
                 ledger: Optional[PrivacyLedger] = None):
        require_token_input(model.arch, "the engine")
        require_whole_params(model, "the engine")
        self.model = model
        self.device = model.device
        self.B = max_batch
        self.S = cache_len
        # power-of-two sub-chunks, as in the JAX engine (there: a bounded
        # set of compiled lengths; here: the same step schedule)
        self.decode_chunk = _pow2_floor(max(1, decode_chunk))
        self.prefill_chunk = max(1, prefill_chunk)
        self.record_ttft = record_ttft
        self.clock = clock
        self.has_mamba = MAMBA in model.arch.pattern()
        self.paged = paged
        self.ledger = ledger
        self.pool: Optional[BlockPool] = None
        if paged:
            if self.has_mamba:
                raise ValueError("paged=True requires an attention-only "
                                 "architecture (SSM state is O(1) per slot)")
            if cache_len % block_size != 0:
                raise ValueError(f"cache_len ({cache_len}) must be a "
                                 f"multiple of block_size ({block_size})")
            if num_blocks is None:
                # same token capacity as the contiguous slabs
                num_blocks = max_batch * cache_len // block_size
            self.pool = BlockPool(num_blocks, block_size,
                                  prefix_sharing=prefix_sharing)
        self.sched = Scheduler(max_batch, cache_len, policy=policy,
                               same_length_waves=self.has_mamba, clock=clock)
        dev = self.device
        z = lambda dt: torch.zeros((max_batch,), dtype=dt, device=dev)
        self.dev = {
            "cache": (model.init_paged_cache(self.pool.num_blocks, block_size)
                      if paged else model.init_cache(max_batch, cache_len)),
            "tokens": z(torch.int32),
            "pos": z(torch.int64),
            "temps": z(torch.float32),
            "remaining": z(torch.int32),
            "emitted": z(torch.int64),
            "out": torch.zeros((max_batch, cache_len), dtype=torch.int32,
                               device=dev),
        }
        if paged:
            self.dev["tables"] = torch.full(
                (max_batch, cache_len // block_size), self.pool.sentinel,
                dtype=torch.int64, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self._rows = torch.arange(max_batch, device=dev)
        self.stats: Dict[str, int] = dict(
            prefill_waves=0, decode_steps=0, decode_calls=0, host_syncs=0,
            evicted=0, refused=0, deferred=0, max_active=0)
        self.ttft: Dict[int, float] = {}
        self.latency: Dict[int, float] = {}
        self._slot_blocks: Dict[int, List[int]] = {}   # paged: slot -> chain
        self._pending_blocks: Dict[Request, List[int]] = {}
        self._deferred: List[Request] = []    # ledger policy="queue" parking
        self._ledger_version = ledger.version if ledger is not None else 0

    def _idx(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    # -- device programs ------------------------------------------------------
    def _prefill_wave(self, toks, lengths, slots, temps, budgets,
                      wave_tables=None) -> None:
        """One admission wave of n requests.  toks: (n, Tpad) right-padded
        prompts; slots: (n,) distinct free slots (host arrays)."""
        model, d = self.model, self.dev
        Tpad = toks.shape[1]
        lengths_t = self._idx(lengths)
        temps_t = torch.as_tensor(temps, device=self.device)
        logits, c1 = model.prefill(self._idx(toks), Tpad, lengths=lengths_t)
        first = sample_tokens(logits[:, 0], temps_t, model.arch.vocab,
                              self.gen)
        slots_t = self._idx(slots)
        cache = d["cache"]
        # (batch axis, slot cache, wave cache): prelude leaves carry the
        # batch at axis 0, stacked block leaves after the (reps,) axis
        pairs = [(0, cb, cw) for cb, cw in zip(cache["prelude"], c1["prelude"])]
        if cache["blocks"] is not None:
            pairs += [(1, cb, cw) for cb, cw in zip(cache["blocks"], c1["blocks"])]
        if wave_tables is None:
            # the dim after the batch is an attention leaf's positions (the
            # wave's Tpad of the slot's S) or a Mamba state's own (whole)
            for axis, cb, cw in pairs:
                for dst, src in zip(cb, cw):
                    idx = (slice(None),) * axis + (slots_t, slice(0, src.shape[axis + 1]))
                    dst[idx] = src.to(dst.dtype)
        else:
            # scatter whole blocks through the wave's tables; sentinel
            # entries (past a short request's chain) are dropped here on
            # the host.  Prefix-shared blocks may appear for several rows:
            # a shared position's K/V depends only on the identical tokens
            # at or before it, so every duplicate carries the same bytes
            # and the write order of index_put_ does not matter.
            bs = self.pool.block_size
            nbw = Tpad // bs
            wt = wave_tables[:, :nbw]
            rows, cols = np.nonzero(wt != self.pool.sentinel)
            dst_b, rows_t, cols_t = (self._idx(wt[rows, cols]),
                                     self._idx(rows), self._idx(cols))
            for _, cb, cw in pairs:
                for dst, src in zip(cb, cw):
                    lead = src.shape[:-4]            # () or (reps,)
                    src = src.reshape(lead + (src.shape[-4], nbw, bs)
                                      + src.shape[-2:])
                    dst[..., dst_b, :, :, :] = \
                        src[..., rows_t, cols_t, :, :, :].to(dst.dtype)
            d["tables"][slots_t] = self._idx(wave_tables)
        d["tokens"][slots_t] = first
        d["pos"][slots_t] = lengths_t
        d["temps"][slots_t] = temps_t
        d["remaining"][slots_t] = self._idx(budgets).to(torch.int32) - 1
        d["emitted"][slots_t] = 1
        d["out"][slots_t, 0] = first

    def _decode_chunk(self, n: int, all_greedy: bool) -> None:
        """n decode-sample steps.  Slots whose budget is spent are
        live-masked: their tokens, positions and counters freeze.
        ``all_greedy`` (known on the host) skips the random draw; greedy
        tokens never depend on it, so both variants emit the same greedy
        streams."""
        model, d, S = self.model, self.dev, self.S
        vocab = model.arch.vocab
        for _ in range(n):
            if self.paged:
                logits, _ = model.decode_step_paged(
                    d["cache"], d["tokens"][:, None], d["pos"], d["tables"])
            else:
                logits, _ = model.decode_step(d["cache"], d["tokens"][:, None],
                                              d["pos"])
            if all_greedy:
                tok = torch.argmax(mask_padded_vocab(logits[:, 0], vocab),
                                   dim=-1).to(torch.int32)
            else:
                tok = sample_tokens(logits[:, 0], d["temps"], vocab, self.gen)
            live = d["remaining"] > 0
            tok = torch.where(live, tok, d["tokens"])
            # a dead slot's write (index S in the JAX engine, dropped there)
            # rewrites the value already in its own row
            idx = d["emitted"].clamp(max=S - 1)
            d["out"][self._rows, idx] = torch.where(
                live, tok, d["out"][self._rows, idx])
            d["tokens"] = tok
            d["pos"] = d["pos"] + live
            d["remaining"] = d["remaining"] - live.to(torch.int32)
            d["emitted"] = d["emitted"] + live

    # -- public API ---------------------------------------------------------
    def _charge_of(self, req: Request) -> Optional[RequestCharge]:
        if req.charge is not None:
            return req.charge
        return self.ledger.default_charge if self.ledger else None

    def submit(self, req: Request) -> None:
        self.sched.validate(req)
        if self.paged:
            need = blocks_for(len(req.prompt) + req.max_new,
                              self.pool.block_size)
            if need > self.pool.num_blocks:
                raise ValueError(
                    f"req {req.uid}: needs {need} blocks, pool has "
                    f"{self.pool.num_blocks} total")
        if self.ledger is not None and req.user is not None:
            if not self.ledger.admits(req.user, self._charge_of(req)):
                if self.ledger.policy == "refuse":
                    self.stats["refused"] += 1
                    raise BudgetExceeded(req.user,
                                         self.ledger.epsilon(req.user),
                                         self.ledger.budget_eps)
                req.submit_time = self.sched.clock()
                self._deferred.append(req)
                self.stats["deferred"] += 1
                return
        self.sched.submit(req)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Serve everything submitted.  Returns {uid: tokens}; evicted
        requests report the tokens they got before their deadline.
        ``max_steps`` overruns raise ``StepBudgetExceeded`` with the
        already-completed outputs attached as ``.results``."""
        results: Dict[int, List[int]] = {}
        sched = self.sched
        start_steps = self.stats["decode_steps"]
        self._replay_deferred()
        while sched.has_work():
            now = self.clock()
            self._replay_deferred()
            for req in sched.evict_expired_queued(now):
                results[req.uid] = []
                self.latency[req.uid] = now - req.submit_time
                self.stats["evicted"] += 1
            overdue = sched.evict_overdue_active(now)
            if overdue:
                rows = self._fetch_out()
                for slot, s in overdue:
                    results[s.request.uid] = rows[slot][:s.emitted].tolist()
                    self.latency[s.request.uid] = now - s.request.submit_time
                    self.stats["evicted"] += 1
                self._release([slot for slot, _ in overdue])
            wave = sched.next_wave(gate=self._gate(results))
            if wave:
                self._dispatch_prefill(wave)
                sched.admit(wave, now)
                self.stats["max_active"] = max(
                    self.stats["max_active"],
                    self.B - len(sched.free_slots()))
            self._collect(results)          # max_new=1 finishes at admit
            steps = sched.steps_to_next_completion()
            if steps is None:
                continue
            # queue waiting -> stop at the next completion so the freed
            # slot readmits promptly; queue empty -> run every slot dry
            n = steps if sched.queue else sched.max_remaining()
            if max_steps is not None:
                done_steps = self.stats["decode_steps"] - start_steps
                if done_steps + n > max_steps:
                    raise StepBudgetExceeded(
                        f"engine exceeded max_steps={max_steps} "
                        f"(decode_steps this call: {done_steps}; "
                        f"{len(results)} completed outputs attached)",
                        results)
            all_greedy = all(s.request.temperature <= 0
                             for s in sched.slots if s is not None)
            deadlines = [s.request.deadline for s in sched.slots
                         if s is not None and s.request.deadline is not None]
            while n > 0:
                c = (self.decode_chunk if n >= self.decode_chunk
                     else _pow2_floor(n))
                self._decode_chunk(c, all_greedy)
                sched.advance(c)
                n -= c
                self.stats["decode_steps"] += c
                self.stats["decode_calls"] += 1
                if deadlines and self.clock() > min(deadlines):
                    break       # loop top evicts at this chunk boundary
            self._collect(results)
        return results

    # -- internals ----------------------------------------------------------
    def _replay_deferred(self) -> None:
        """Re-submit ledger-deferred requests after a budget refresh
        (detected via the ledger's version counter)."""
        if self.ledger is None or self.ledger.version == self._ledger_version:
            return
        self._ledger_version = self.ledger.version
        parked, self._deferred = self._deferred, []
        for req in parked:
            self.submit(req)

    def _gate(self, results: Dict[int, List[int]]):
        """Admission gate for ``Scheduler.next_wave``: ledger verdicts
        remove the request from the queue ("skip"), block-pool exhaustion
        closes the wave ("stop").  The ledger charge commits here, at pick
        time, so queued requests of one user cannot overdraw together."""
        def gate(req: Request):
            if self.ledger is not None and req.user is not None:
                charge = self._charge_of(req)
                if not self.ledger.admits(req.user, charge):
                    if self.ledger.policy == "queue":
                        self._deferred.append(req)
                        self.stats["deferred"] += 1
                    else:
                        results[req.uid] = []
                        self.latency[req.uid] = (self.clock()
                                                 - req.submit_time)
                        self.stats["refused"] += 1
                    return "skip"
            if self.paged:
                chain = self.pool.alloc(np.asarray(req.prompt),
                                        len(req.prompt) + req.max_new)
                if chain is None:
                    return "stop"
                self._pending_blocks[req] = chain
            if self.ledger is not None and req.user is not None:
                self.ledger.charge(req.user, self._charge_of(req))
            return True
        return gate

    def _release(self, slots: List[int]) -> None:
        """Reset freed slots at free/evict time: zero ``remaining`` on the
        device so an evicted slot stops decoding; in paged mode sentinel
        its table row, so its frozen-but-executed cache writes never land
        in blocks the pool hands to another request, and return its blocks
        to the pool."""
        if not slots:
            return
        idx = self._idx(slots)
        self.dev["remaining"][idx] = 0
        if self.paged:
            self.dev["tables"][idx] = self.pool.sentinel
            for slot in slots:
                chain = self._slot_blocks.pop(slot, None)
                if chain is not None:
                    self.pool.free(chain)

    def _dispatch_prefill(self, wave) -> None:
        Ls = [len(r.prompt) for _, r in wave]
        if self.has_mamba:
            # an equal-length wave, unpadded: pad tokens would enter the
            # recurrent state
            Tpad = Ls[0]
        elif self.paged:
            # Tpad must be a block_size multiple so the wave cache reshapes
            # into whole blocks for the table scatter
            bs = self.pool.block_size
            Tpad = min(_round_up(_round_up(max(Ls), self.prefill_chunk), bs),
                       self.S)
        else:
            Tpad = min(_round_up(max(Ls), self.prefill_chunk), self.S)
        n = len(wave)
        toks = np.zeros((n, Tpad), np.int64)
        lengths = np.array(Ls, np.int64)
        slots = np.array([slot for slot, _ in wave], np.int64)
        temps = np.array([r.temperature for _, r in wave], np.float32)
        budgets = np.array([r.max_new for _, r in wave], np.int64)
        for i, (_, r) in enumerate(wave):
            toks[i, :len(r.prompt)] = r.prompt
        wave_tables = None
        if self.paged:
            nb_max = self.S // self.pool.block_size
            wave_tables = np.full((n, nb_max), self.pool.sentinel, np.int64)
            for i, (slot, r) in enumerate(wave):
                chain = self._pending_blocks.pop(r)
                self._slot_blocks[slot] = chain
                wave_tables[i] = self.pool.table_row(chain, nb_max)
        self._prefill_wave(toks, lengths, slots, temps, budgets, wave_tables)
        self.stats["prefill_waves"] += 1
        if self.record_ttft:
            self._sync()
            t = self.clock()
            for _, r in wave:
                self.ttft[r.uid] = t - r.submit_time

    def _sync(self) -> None:
        self.stats["host_syncs"] += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fetch_out(self) -> np.ndarray:
        self.stats["host_syncs"] += 1
        return self.dev["out"].cpu().numpy()

    def _collect(self, results: Dict[int, List[int]]) -> None:
        fins = self.sched.pop_finished()
        if not fins:
            return
        rows = self._fetch_out()
        now = self.clock()
        for slot, s in fins:
            results[s.request.uid] = rows[slot][:s.emitted].tolist()
            self.latency[s.request.uid] = now - s.request.submit_time
        if self.paged:
            # finished slots have remaining == 0 on the device already, but
            # their table rows must go to sentinel before the pool reuses
            # the blocks (the frozen slot still executes cache writes)
            self._release([slot for slot, _ in fins])
