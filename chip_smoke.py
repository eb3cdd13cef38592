#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; a failure in any of them raises, so
the script exits nonzero and prints no ``ok`` line:

1. the device: torch's name for it and ``nvidia-smi``'s name and power limit;
2. build every CUDA kernel of the port from this checkout's sources;
3. every kernel against its plain PyTorch version on the card, timed beside
   the plain version, the one PyTorch call computing the same function
   (``library_ms``, timing only) and the card's bound;
4. a small reference: the reduced phi3 model in float32, prefill and decode
   logits on the card (through the kernel) against the CPU (plain path);
5. the main path: phi3-mini-3.8b at full width and depth, bf16, seeded
   random weights, serving 16 greedy requests through the contiguous engine
   and the same stream through the paged engine; outputs must agree.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.  Needs one card.  Measurements also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
F32_TOL = dict(rtol=2e-4, atol=2e-5)     # as tests/test_kernels.py
BF16_ATOL = 2e-2                          # bf16 vs the plain version in f32
# the main path's traffic: 16 greedy requests, prompts of 64-1024 tokens,
# 64 new tokens each, through 8 slots of a 2048-position cache
N_REQUESTS, MAX_NEW, MAX_BATCH, CACHE_LEN, BLOCK = 16, 64, 8, 2048, 16


def request_stream(vocab: int, seed: int = 0):
    """The main path's prompts, made with numpy from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(64, 1025, N_REQUESTS)
    return [rng.integers(0, vocab, int(n)) for n in lengths]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(BH, T, S, hd, rep, causal, dtype_name):
    """Least time for the work: FLOPs (QK^T and PV, halved when causal)
    over the type's peak, against bytes (q, k, v read once; o, lse written
    once) over HBM bandwidth.  Returns (ms, "operations" | "bytes")."""
    item = 2 if dtype_name == "bfloat16" else 4
    flops = 4.0 * BH * T * S * hd * (0.5 if causal else 1.0)
    nbytes = item * (2 * BH * T * hd + 2 * (BH // rep) * S * hd) + 4 * BH * T
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_flash(name, B, H, KV, T, hd, causal, dtype, seed=0):
    """One shape: kernel vs plain version on the card, and timings."""
    import torch
    from repro_torch.kernels import flash_attn, ref
    rep = H // KV
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda rows: torch.randn((rows, T, hd), generator=g, device="cuda").to(dtype)
    q, k, v = mk(B * H), mk(B * KV), mk(B * KV)
    o, lse = flash_attn.flash_attn_fwd(q, k, v, causal=causal, rep=rep)
    torch.cuda.synchronize()
    o_ref, lse_ref = ref.flash_attn_fwd_ref(q.float(), k.float(), v.float(),
                                            causal, rep)
    err = max((o.float() - o_ref).abs().max().item(),
              (lse - lse_ref).abs().max().item())
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_ref, **F32_TOL)
        torch.testing.assert_close(lse, lse_ref, **F32_TOL)
    else:
        torch.testing.assert_close(o.float(), o_ref, rtol=0.0, atol=BF16_ATOL)
        torch.testing.assert_close(lse, lse_ref, rtol=0.0, atol=BF16_ATOL)
    ms = time_ms(lambda: flash_attn.flash_attn_fwd(q, k, v, causal=causal, rep=rep))
    plain_ms = time_ms(lambda: ref.flash_attn_fwd_ref(q, k, v, causal, rep))
    # timing only: the port never calls it
    q4, k4, v4 = q[None], k[None], v[None]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, enable_gqa=rep > 1))
    dt = str(dtype).split(".")[-1]
    bound_ms, bound_by = flash_bound_ms(B * H, T, T, hd, rep, causal, dt)
    rec = dict(shape=name, dtype=dt, BH=B * H, T=T, S=T, hd=hd, rep=rep,
               causal=causal, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernel] flash_attn_fwd {name} {dt}: max_abs_err {err:.3e}  "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return rec


def small_reference(device_b: str = "cuda"):
    """Reduced phi3 in float32: logits on ``device_b`` (the kernel path on
    the card) against the CPU (plain path), same weights."""
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import Model
    arch = reduced(get_arch("phi3-mini-3.8b"))
    a = Model(arch, dtype=torch.float32, device="cpu", seed=0)
    b = Model(arch, a.params, dtype=torch.float32, device=device_b)
    toks = torch.randint(0, arch.vocab, (3, 70), generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([70, 41, 9])
    la, ca = a.prefill(toks, 80, lengths)
    lb, cb = b.prefill(toks.to(device_b), 80, lengths.to(device_b))
    worst = (lb.cpu() - la).abs().max().item()
    torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=1e-4)
    pos = lengths.clone()
    for _ in range(3):
        nxt = la[:, 0, :arch.vocab].argmax(-1)[:, None]
        la, ca = a.decode_step(ca, nxt, pos)
        lb, cb = b.decode_step(cb, nxt.to(device_b), pos.to(device_b))
        worst = max(worst, (lb.cpu() - la).abs().max().item())
        torch.testing.assert_close(lb.cpu(), la, rtol=1e-4, atol=1e-4)
        pos = pos + 1
    print(f"[reference] reduced phi3 f32 prefill + 3 decode steps, {device_b} "
          f"vs cpu: max |dlogits| {worst:.3e} (rtol/atol 1e-4)", flush=True)


def serve(model, prompts, max_new, paged):
    """Serve ``prompts`` greedily; returns (outputs, engine, seconds,
    {"prefill": s, "decode": s}): time inside prefill waves and decode
    chunks, each synchronised at its ends (one sync per wave or chunk)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.scheduler import Request
    eng = Engine(model, max_batch=MAX_BATCH, cache_len=CACHE_LEN, paged=paged,
                 block_size=BLOCK, record_ttft=True)
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(key, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
        return run

    eng._prefill_wave = timed("prefill", eng._prefill_wave)
    eng._decode_chunk = timed("decode", eng._decode_chunk)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p.astype(np.int32), max_new=max_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    return out, eng, time.perf_counter() - t0, spent


def decode_breakdown(model, B=MAX_BATCH, S=CACHE_LEN, block_size=BLOCK):
    """Device time of one layer's decode pieces at the main path's cache
    shape (B slots, S positions, half full): attention against the
    contiguous cache, attention through block tables, the MLP; and the LM
    head once."""
    import torch
    from repro_torch.models import layers as L
    arch = model.arch
    p = {k: ({n: w[0] for n, w in v.items()} if isinstance(v, dict) else v[0])
         for k, v in model.params["blocks"][0].items()}      # layer 0
    h = torch.randn((B, 1, arch.d_model), device="cuda").to(model.dtype)
    pos = torch.full((B,), S // 2, dtype=torch.int64, device="cuda")
    kv = tuple(torch.randn((B, S, arch.n_kv_heads, arch.hd), device="cuda")
               .to(model.dtype) for _ in range(2))
    nb = B * S // block_size
    pool = tuple(a.reshape(nb, block_size, arch.n_kv_heads, arch.hd) for a in kv)
    tables = torch.arange(nb, device="cuda").reshape(B, S // block_size)
    ms = {
        "attn_contiguous": time_ms(lambda: L.attn_decode(p["attn"], h, kv, pos, arch)),
        "attn_paged": time_ms(lambda: L.attn_decode_paged(p["attn"], h, pool,
                                                          tables, pos, arch)),
        "mlp": time_ms(lambda: L.mlp_apply(p["mlp"], h, arch)),
        "head": time_ms(lambda: h @ model.params["head"]),
    }
    n = arch.n_layers
    print(f"[main] one layer's decode at B={B}, S={S}: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; x{n} layers: attention {n * ms['attn_contiguous']:.1f} ms "
          f"(contiguous) / {n * ms['attn_paged']:.1f} ms (paged), mlp "
          f"{n * ms['mlp']:.1f} ms per step", flush=True)
    return ms


def main_path(arch, prompts):
    """Serve ``prompts`` on ``arch`` at full size, bf16, seeded weights,
    through the contiguous and then the paged engine."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attn
    from repro_torch.models.transformer import Model
    t = time.perf_counter()
    model = Model(arch, dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    print(f"[main] {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, "
          f"{arch.n_heads} heads x hd {arch.hd}, d_ff {arch.d_ff}, vocab "
          f"{arch.vocab}; {n_par / 1e9:.3f}B params bf16, init "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    # warm-up (cuBLAS handles, allocator), outside the counted runs
    serve(model, prompts[:2], 2, paged=False)
    n_attn = arch.n_layers
    runs, launches = {}, 0
    for paged in (False, True):
        flash_attn.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        out, eng, dt, spent = serve(model, prompts, MAX_NEW, paged)
        n_launch = flash_attn.LAUNCHES
        launches += n_launch
        waves = eng.stats["prefill_waves"]
        kind = "paged" if paged else "contiguous"
        assert sorted(out) == list(range(len(prompts))), kind
        for uid, toks in out.items():
            assert len(toks) == MAX_NEW, (kind, uid, len(toks))
            assert all(0 <= x < arch.vocab for x in toks), (kind, uid)
        assert n_launch >= n_attn * waves, (kind, n_launch, waves)
        n_tok = sum(len(v) for v in out.values())
        steps = eng.stats["decode_steps"]
        rec = dict(engine=kind, requests=len(prompts), tokens=n_tok,
                   seconds=dt, tok_per_s=n_tok / dt,
                   mean_ttft_ms=1e3 * float(np.mean(list(eng.ttft.values()))),
                   decode_ms_per_step=1e3 * spent["decode"] / max(steps, 1),
                   prefill_ms_per_wave=1e3 * spent["prefill"] / max(waves, 1),
                   decode_steps=steps, prefill_waves=waves,
                   flash_launches=n_launch,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   prompt_tokens=sum(len(p) for p in prompts))
        runs[kind] = (out, rec)
        print(f"[main] {kind}: {n_tok} tokens in {dt:.2f} s ({rec['tok_per_s']:.1f} "
              f"tok/s), mean TTFT {rec['mean_ttft_ms']:.1f} ms, decode "
              f"{rec['decode_ms_per_step']:.2f} ms/step over {steps} steps, "
              f"{waves} prefill waves of {rec['prefill_ms_per_wave']:.1f} ms, "
              f"flash launches {n_launch}, peak "
              f"{rec['max_memory_allocated'] / 2**30:.2f} GiB", flush=True)
        del eng
        torch.cuda.empty_cache()
    assert runs["paged"][0] == runs["contiguous"][0], \
        "paged greedy outputs differ from the contiguous engine's"
    print("[main] paged greedy outputs equal the contiguous engine's", flush=True)
    breakdown = decode_breakdown(model)
    return [rec for _, rec in runs.values()], launches, breakdown


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the "
              "card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 references
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch: {name}, {torch.cuda.device_count()} device(s); "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(f"[device] nvidia-smi: {smi}", flush=True)

    # 2. build
    t = time.perf_counter()
    logs = build.build()
    print(f"[build] {', '.join(build.sources())}: {len(logs)} compiled in "
          f"{time.perf_counter() - t:.1f} s (the others were built from the "
          f"same source already)", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")

    # 3. kernels vs plain, at the shapes of the main path and the issue's
    arch = get_arch("phi3-mini-3.8b")
    prompts = request_stream(arch.vocab)
    # the first prefill wave's padded length (engine: round up to 16)
    wave_t = -(-max(len(p) for p in prompts[:MAX_BATCH]) // 16) * 16
    shapes = [("phi3-wave", 8, 32, 32, wave_t, 96, True),
              ("phi3", 4, 32, 32, 1024, 96, True),
              ("starcoder2-gqa", 1, 36, 4, 777, 128, True),
              ("starcoder2-gqa-full", 1, 36, 4, 333, 128, False)]
    kernel_recs = []
    for shp in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            kernel_recs.append(check_flash(*shp, dtype))

    # 4. small reference
    small_reference("cuda")

    # 5. main path
    runs, launches, breakdown = main_path(arch, prompts)

    main_rec = next(r for r in kernel_recs
                    if r["shape"] == "phi3-wave" and r["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attn.py:77",
        "launches": launches, "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"], "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"], "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"]}]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "kernels": kernel_recs,
         "main": runs, "decode_breakdown_ms": breakdown}, indent=1))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
