"""The analytical accelerator model of the paper (WS/OS systolic arrays and
DiVa's outer-product engine): a copy of ``repro/sim``, which imports no
JAX, kept here because the port imports nothing of ``repro``."""
from repro_torch.sim.dataflow import (DIVA, OS, WS, Accel, gemm_cycles, gemm_time,
                                dp_training_time, util)

__all__ = ["WS", "OS", "DIVA", "Accel", "gemm_cycles", "gemm_time", "util",
           "dp_training_time"]
