"""Analytical cycle + energy model of WS/OS systolic arrays and DiVa's
outer-product engine (paper §II-D, §IV, §V) — the paper-faithful evaluation
artifact used by the Fig. 7/13/15/16 and Table I benchmarks.

Model (paper Table II config: 128x128 PEs @ 940 MHz, 16 MB SRAM,
450 GB/s HBM):

* WS systolic: RHS (K,N) latched tile-by-tile (8 rows/cycle fill); LHS
  streams M rows with a PE_H pipeline skew.
    cycles = ceil(K/H)·ceil(N/W) · (H/8 + M + H)
* OS systolic: output (M,N) tiles; operand vectors stream K deep with
  fill+drain skew.
    cycles = ceil(M/H)·ceil(N/W) · (K + H + W)
* DiVa outer-product: output-stationary all-to-all; M x N MACs every cycle
  regardless of K; PPU drains R=8 rows/cycle (overlapped).
    cycles = ceil(M/H)·ceil(N/W) · (K + W/R)

Gradient post-processing (norm/clip/reduce) is memory-bound on WS (the
per-example grads spill to DRAM, Fig. 10a); with an OS dataflow + PPU it is
fused on the output drain (Fig. 10b) and costs no extra DRAM traffic.

Energy = engine power x busy time + DRAM energy/byte x DRAM traffic
(engine powers from paper Table III; DRAM ~20 pJ/B per Horowitz).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Tuple

GEMM = Tuple[int, int, int]          # (M, K, N)


@dataclasses.dataclass(frozen=True)
class Accel:
    name: str
    pe_h: int = 128
    pe_w: int = 128
    freq: float = 940e6
    dram_bw: float = 450e9           # bytes/s (Table II)
    power_w: float = 13.4            # engine power (Table III)
    fused_norm: bool = False         # PPU / on-the-fly norm derivation
    dataflow: str = "ws"             # ws | os | outer

    @property
    def macs(self) -> int:
        return self.pe_h * self.pe_w

    @property
    def peak_flops(self) -> float:
        return 2 * self.macs * self.freq


WS = Accel("systolic-ws", dataflow="ws", power_w=13.4)
OS = Accel("systolic-os", dataflow="os", power_w=13.6)
OS_PPU = Accel("systolic-os+ppu", dataflow="os", power_w=13.6 + 2.6,
               fused_norm=True)
DIVA_NOPPU = Accel("diva-noppu", dataflow="outer", power_w=21.2 - 2.6)
DIVA = Accel("diva", dataflow="outer", power_w=21.2, fused_norm=True)

DRAM_E_PER_BYTE = 20e-12             # J/B (Horowitz-style)
BYTES_IN = 2                         # bf16 operands
BYTES_OUT = 4                        # f32 accumulators


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def pegrad_spill_bytes(batch: int, weight_elems: int) -> float:
    """DRAM bytes of the materialized per-example weight gradients: one f32
    gradient per example (paper Fig. 4's dominant DP-SGD allocation).

    The single sizing rule shared by the analytical accelerator model
    (``dp_training_time`` below prices spilling/fetching exactly this many
    bytes on non-PPU dataflows) and the JAX-side resident-memory estimator
    (``launch/memory.py::per_example_grad_bytes``) — so the two accountings
    can be cross-checked against each other in one test
    (tests/test_memory.py).
    """
    return float(batch) * float(weight_elems) * BYTES_OUT


def gemm_cycles(acc: Accel, g: GEMM) -> float:
    m, k, n = g
    h, w = acc.pe_h, acc.pe_w
    if acc.dataflow == "ws":
        tiles = _ceil(k, h) * _ceil(n, w)
        return tiles * (h / 8 + m + h)
    if acc.dataflow == "os":
        tiles = _ceil(m, h) * _ceil(n, w)
        return tiles * (k + h + w)
    tiles = _ceil(m, h) * _ceil(n, w)
    return tiles * (k + w / 8)       # outer-product + pipelined PPU drain


def gemm_time(acc: Accel, g: GEMM) -> float:
    """Seconds, including a DRAM-bandwidth floor for streaming operands."""
    m, k, n = g
    t_compute = gemm_cycles(acc, g) / acc.freq
    bytes_moved = BYTES_IN * (m * k + k * n) + BYTES_OUT * m * n
    t_mem = bytes_moved / acc.dram_bw
    return max(t_compute, t_mem)


def util(acc: Accel, g: GEMM) -> float:
    m, k, n = g
    return (m * k * n) / (gemm_cycles(acc, g) * acc.macs)


# ---------------------------------------------------------------------------
# DP-SGD(R) end-to-end step model (paper Fig. 13/14 structure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepBreakdown:
    forward: float = 0.0
    wgrad_batch: float = 0.0         # per-batch weight grads (+2nd pass)
    dgrad: float = 0.0               # input-activation grads
    wgrad_example: float = 0.0       # per-example weight grads
    norm: float = 0.0                # gradient norm derivation
    postproc: float = 0.0            # clip / reduce / noise
    dram_bytes: float = 0.0

    @property
    def total(self) -> float:
        return (self.forward + self.wgrad_batch + self.dgrad
                + self.wgrad_example + self.norm + self.postproc)


def dp_training_time(acc: Accel, layers: Iterable, batch: int,
                     algo: str = "dpsgd_r") -> StepBreakdown:
    """layers: iterable of LayerGEMMs (sim.models).  Returns per-step
    seconds by stage, following the paper's stage taxonomy (Fig. 5/14)."""
    bd = StepBreakdown()
    for L in layers:
        bd.forward += gemm_time(acc, L.fwd(batch))
        bd.dgrad += gemm_time(acc, L.dgrad(batch))
        w_elems = L.weight_elems()
        norm_bytes = pegrad_spill_bytes(batch, w_elems)
        # per-example weight gradients: B independent small-K GEMMs whose
        # operands are SRAM-resident (they were just produced); only the
        # per-example grad spill (if any) touches DRAM.
        g_ex = L.wgrad_example()
        t_ex_compute = batch * gemm_cycles(acc, g_ex) / acc.freq
        spill_write = 0.0 if acc.fused_norm else norm_bytes
        if algo == "sgd":
            bd.wgrad_batch += gemm_time(acc, L.wgrad_batch(batch))
            continue
        bd.wgrad_example += max(t_ex_compute, spill_write / acc.dram_bw)
        bd.dram_bytes += spill_write
        if algo == "dpsgd_r":
            # norms fused on the output drain for PPU designs; otherwise the
            # spilled grads are fetched back for the vector unit (Fig. 10a).
            # 2nd backprop derives clipped per-batch grads (fused clip/red.)
            bd.wgrad_batch += gemm_time(acc, L.wgrad_batch(batch))
            bd.dgrad += gemm_time(acc, L.dgrad(batch))     # 2nd pass dgrad
            if not acc.fused_norm:
                bd.norm += norm_bytes / acc.dram_bw        # fetch for norms
                bd.dram_bytes += norm_bytes
        else:  # vanilla dpsgd: norm fetch + clip/reduce all over DRAM
            if not acc.fused_norm:
                bd.norm += norm_bytes / acc.dram_bw
                bd.dram_bytes += norm_bytes
            clipred = 2 * norm_bytes + w_elems * BYTES_OUT
            bd.postproc += clipred / acc.dram_bw
            bd.dram_bytes += clipred
    return bd


def step_energy(acc: Accel, bd: StepBreakdown) -> float:
    return acc.power_w * bd.total + DRAM_E_PER_BYTE * bd.dram_bytes


# ---------------------------------------------------------------------------
# Traced-program pricing (launch/autotune.py fitness backend)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TracedStep:
    """Cycle-model seconds for a *traced* train step (launch/costs.py GEMM
    records), the generalization of ``dp_training_time`` the launch
    autotuner scores candidates with: instead of the paper's fixed
    per-layer fwd/dgrad/wgrad taxonomy, every dot_general / conv the
    program actually traces — remat recompute, second backward passes,
    norm-rule einsums, grad-accum scan trips — is priced individually
    through the same ``gemm_time`` engine model."""
    gemm: float = 0.0            # sum of per-GEMM times (compute/BW max)
    elementwise: float = 0.0     # memory-bound non-GEMM work
    collective: float = 0.0      # cross-device gradient reduction
    dram_bytes: float = 0.0

    @property
    def total(self) -> float:
        return self.gemm + self.elementwise + self.collective


def traced_step_time(acc: Accel, gemms: Iterable[Tuple[int, int, int, float]],
                     ew_flops: float = 0.0, move_bytes: float = 0.0,
                     n_devices: int = 1, coll_bytes: float = 0.0,
                     ici_bw: float = 50e9) -> TracedStep:
    """Price a traced step on ``acc``.

    ``gemms``: ``(m, k, n, mult)`` records from ``launch/costs.py``
    (``Costs.gemm_list``) — the program's GEMMs with scan multiplicities.
    ``ew_flops`` / ``move_bytes``: the non-GEMM accounting from the same
    walk, priced as DRAM-bandwidth-bound (one f32 write per elementwise
    output element).  Compute and per-program-point HBM traffic divide
    over ``n_devices`` (data/model parallel work split); ``coll_bytes``
    is per-device wire traffic priced at ``ici_bw``.
    """
    ts = TracedStep()
    dev = max(1, int(n_devices))
    gemm_bytes = 0.0
    for m, k, n, mult in gemms:
        ts.gemm += mult * gemm_time(acc, (int(m), int(k), int(n)))
        gemm_bytes += mult * (BYTES_IN * (m * k + k * n) + BYTES_OUT * m * n)
    ts.gemm /= dev
    ew_bytes = move_bytes + BYTES_OUT * ew_flops
    ts.elementwise = ew_bytes / acc.dram_bw / dev
    ts.collective = coll_bytes / ici_bw
    ts.dram_bytes = (gemm_bytes + ew_bytes) / dev + coll_bytes
    return ts
