"""Serving launcher of the port: continuous batching on the card.

  python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
      --requests 8 --max-new 16 --cache-len 128 --policy shortest-prompt

Same flags as ``repro.launch.serve`` plus ``--device`` (default ``cuda``),
``--dtype`` (default ``bfloat16``) and ``--set moe.<field>=<value>`` (an
MoE arch's expert config, e.g. ``--set moe.capacity_factor=2.0``).  Weights
are a seeded random init.  Token-input archs only, as the JAX launcher: an
embedding-input arch (musicgen-medium, chameleon-34b) raises.
``--engine host-loop`` runs the host-loop reference engine
(``serve/host_loop.py``) instead of the device engine (``jitted``, the
JAX package's name for it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import (apply_overrides, get_arch, parse_set_args,
                                 reduced)
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Engine, require_token_input
from repro_torch.serve.host_loop import HostLoopEngine
from repro_torch.serve.ledger import (BudgetExceeded, PrivacyLedger,
                                      RequestCharge)
from repro_torch.serve.scheduler import Request, Scheduler

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def gen_prompts(rng, n: int, prompt_len: int, vocab: int):
    """n random prompts with lengths in [min(4, prompt_len), prompt_len]."""
    if prompt_len < 1:
        raise ValueError(f"--prompt-len must be >= 1, got {prompt_len}")
    lo = min(4, prompt_len)
    return [rng.integers(0, vocab, int(rng.integers(lo, prompt_len + 1)))
            for _ in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=["jitted", "host-loop"],
                    default="jitted")
    ap.add_argument("--policy", choices=list(Scheduler.POLICIES),
                    default="fifo")
    ap.add_argument("--decode-chunk", type=int, default=16,
                    help="decode steps between host checks "
                         "(floored to a power of two)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds, measured from "
                         "just before the engine starts")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (default: the contiguous "
                         "max_batch x cache_len capacity)")
    ap.add_argument("--budget-eps", type=float, default=None,
                    help="per-user privacy budget: attach a ledger and "
                         "tag request i with user 'tenant-<i %% 4>'")
    ap.add_argument("--ledger-delta", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--set", action="append", default=[],
                    help="arch overrides, e.g. --set moe.top_k=1")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    sets = parse_set_args(args.set)
    bad = sorted(k for k in sets if not k.startswith("moe."))
    if bad:
        raise ValueError(f"--set {bad}: the serving launcher takes moe.* "
                         f"keys only")
    arch = apply_overrides(arch, sets)
    require_token_input(arch, "serve launcher")
    if arch.moe.enabled:
        print(f"[serve] {arch.moe}", flush=True)
    model = Model(arch, dtype=DTYPES[args.dtype], device=args.device,
                  seed=args.seed)
    ledger = None
    if args.engine == "host-loop":
        if args.deadline is not None or args.policy != "fifo":
            print("[serve] WARNING: --deadline/--policy are ignored by the "
                  "host-loop reference engine (FIFO, no eviction)")
        engine = HostLoopEngine(model, max_batch=args.max_batch,
                                cache_len=args.cache_len, seed=args.seed)
    else:
        if args.budget_eps is not None:
            # q=0.01, sigma=4.0 prices one request at eps ~0.0554 (delta 1e-6)
            ledger = PrivacyLedger(
                args.budget_eps, args.ledger_delta, policy="refuse",
                default_charge=RequestCharge(sample_rate=0.01,
                                             noise_multiplier=4.0))
        engine = Engine(model, max_batch=args.max_batch,
                        cache_len=args.cache_len, seed=args.seed,
                        policy=args.policy, decode_chunk=args.decode_chunk,
                        record_ttft=True, paged=args.paged,
                        block_size=args.block_size,
                        num_blocks=args.num_blocks, ledger=ledger)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    prompts = gen_prompts(rng, args.requests, args.prompt_len, arch.vocab)
    now = time.monotonic()
    deadline = None if args.deadline is None else now + args.deadline
    for uid, prompt in enumerate(prompts):
        req = Request(uid=uid, prompt=prompt.astype(np.int32),
                      max_new=args.max_new, temperature=args.temperature,
                      deadline=deadline,
                      user=f"tenant-{uid % 4}" if ledger else None)
        try:
            engine.submit(req)
        except BudgetExceeded as e:
            print(f"[serve] req {uid} REFUSED: {e}")
    out = engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in out.values())
    for uid in sorted(out):
        print(f"[serve] req {uid}: {out[uid]}")
    print(f"[serve] {len(out)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {model.device}")
    print(f"[serve] stats: {engine.stats}")
    if engine.ttft:
        ms = 1e3 * np.mean(list(engine.ttft.values()))
        print(f"[serve] mean time-to-first-token: {ms:.1f} ms")


if __name__ == "__main__":
    main()
