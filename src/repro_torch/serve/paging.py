"""Block-paged KV-cache allocation for the serving engine.

The port's own copy of ``repro/serve/paging.py`` (numpy only; the JAX
package's ``repro.serve`` cannot be imported without JAX).

The contiguous engine gives every slot a private ``(cache_len, KV, hd)``
slab per attention layer, so HBM is reserved for the *worst-case* request:
``max_batch`` is bounded by ``max_batch x cache_len`` token-slots even
though most requests use a fraction of them.  Paged mode replaces the
per-slot slabs with one device-resident **block pool** per layer —
``(num_blocks, block_size, KV, hd)`` — and a per-slot **block table**
mapping logical cache positions to physical blocks:

    position p of slot b  ->  pool[table[b, p // block_size], p % block_size]

``BlockPool`` is the host-side allocator behind those tables.  It is pure
bookkeeping (the device arrays live in the engine's ``dev`` dict): a free
list, per-block refcounts, and a prefix registry for sharing.

**Deterministic lifetimes make allocation trivial.**  A request's total
token count (``prompt + max_new``) is known at submit time, so the engine
allocates *every* block a request will ever touch at admission — there is
no mid-decode growth, hence no mid-decode OOM and no host sync to discover
one.  Admission becomes a *blocks-free* gate instead of a *slots-free*
gate (``Scheduler.next_wave(gate=...)``).

**Prefix sharing.**  Full blocks of a prompt *head* are content-addressed:
block ``i`` is keyed by ``(parent physical block, tokens in block i)``, so
two requests whose prompts share a head of ``k`` full blocks resolve to
the same ``k`` physical blocks (refcounted).  This is exact because causal
attention makes a position's K/V depend only on tokens at or before it:
the shared head's cache values are bitwise identical between the sharers,
and a later sharer's prefill re-writing the shared blocks writes the same
bytes.  Only *full prompt* blocks are ever registered — a partial tail
block and all decode blocks are private to their request (decode writes
land at positions ``>= prompt_len``, which by construction live in
unshared blocks).

Blocks are freed by refcount when the engine releases a slot (completion
or eviction); a block leaving the registry at refcount zero returns to
the free list.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def blocks_for(total_len: int, block_size: int) -> int:
    """Number of blocks a request touching ``total_len`` positions needs."""
    return -(-total_len // block_size)


class BlockPool:
    """Host-side allocator for a ``num_blocks`` x ``block_size`` KV pool.

    ``sentinel`` (== ``num_blocks``) marks unallocated block-table entries:
    device writes through it are dropped (``layers.put_rows`` and the
    engine's host-side filtering) and gathers are clamped,
    so a released slot's table can never read or write live blocks.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_sharing: bool = True):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"need num_blocks, block_size >= 1; got "
                             f"{num_blocks}, {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.sentinel = num_blocks
        self.prefix_sharing = prefix_sharing
        # pop() takes from the tail: keep it sorted descending so blocks
        # allocate in ascending id order (deterministic tables)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = np.zeros((num_blocks,), np.int32)
        self._key_of: List[Optional[Tuple]] = [None] * num_blocks
        self._registry: Dict[Tuple, int] = {}
        self.stats = dict(fresh=0, reused=0, alloc_failures=0)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def alloc(self, prompt: np.ndarray, total_len: int) -> Optional[List[int]]:
        """Allocate the full block chain for a request: ``total_len`` =
        prompt length + max_new.  Returns physical block ids (logical
        order) or None if the pool cannot satisfy it right now (the
        admission gate's backpressure signal).  Shared prefix blocks do
        not consume free blocks."""
        bs = self.block_size
        n_total = blocks_for(total_len, bs)
        prompt = np.ascontiguousarray(prompt, np.int32)
        reused: List[int] = []
        parent = -1
        if self.prefix_sharing:
            for i in range(len(prompt) // bs):
                key = (parent, prompt[i * bs:(i + 1) * bs].tobytes())
                b = self._registry.get(key)
                if b is None:
                    break
                reused.append(b)
                parent = b
        n_fresh = n_total - len(reused)
        if n_fresh > len(self._free):
            self.stats["alloc_failures"] += 1
            return None
        fresh = [self._free.pop() for _ in range(n_fresh)]
        for b in reused:
            self._ref[b] += 1
        for j, b in enumerate(fresh):
            self._ref[b] = 1
            i = len(reused) + j
            # register only full *prompt* blocks; decode/tail blocks stay
            # private (their future contents are this request's alone)
            if self.prefix_sharing and (i + 1) * bs <= len(prompt):
                key = (parent, prompt[i * bs:(i + 1) * bs].tobytes())
                self._registry[key] = b
                self._key_of[b] = key
                parent = b
        self.stats["fresh"] += n_fresh
        self.stats["reused"] += len(reused)
        return reused + fresh

    def free(self, blocks: List[int]) -> None:
        """Release one request's hold on its block chain (refcounted)."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise AssertionError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                key = self._key_of[b]
                if key is not None and self._registry.get(key) == b:
                    del self._registry[key]
                self._key_of[b] = None
                self._free.append(b)

    def table_row(self, blocks: List[int], width: int) -> np.ndarray:
        """(width,) int32 block-table row: ``blocks`` then sentinel fill."""
        row = np.full((width,), self.sentinel, np.int32)
        row[:len(blocks)] = blocks
        return row
