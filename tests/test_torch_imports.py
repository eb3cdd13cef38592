"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor anything of the JAX package, and no source of the port (or
chip_smoke.py, which drives it on the card) imports them."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IMPORT_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert len(names) >= 15, names
for n in ("repro_torch.launch.memory", "repro_torch.serve.host_loop",
          "repro_torch.sim", "repro_torch.sim.dataflow", "repro_torch.sim.models",
          "repro_torch.dist", "repro_torch.dist.sharding",
          "repro_torch.dist.runtime", "repro_torch.dist.compress",
          "repro_torch.launch.mesh", "repro_torch.launch.roofline",
          "repro_torch.launch.costs", "repro_torch.launch.autotune",
          "repro_torch.launch.dryrun"):
    assert n in names, n
# the tensor-parallel pieces (the model axis's operators, its layout, the
# vocabulary-parallel loss and the refusals) come with the modules above
from repro_torch.dist.runtime import from_model, model_group, model_shard, to_model
from repro_torch.dist.sharding import model_shards
from repro_torch.models.transformer import tp_refusal, vocab_parallel_xent
# and the stage axis's: its layout, point-to-point pipe and refusals
from repro_torch.dist.runtime import StagePipe, broadcast_, stage_group, stage_shard
from repro_torch.dist.sharding import stage_shards
from repro_torch.models.transformer import stage_refusal
# and the dry-run's: a traced mesh, one rank's trace, the serving programs
from repro_torch.launch.dryrun import all_cells, main, run_cell
from repro_torch.launch.costs import traced_rank
from repro_torch.launch.memory import estimate_serve_memory, serve_program
from repro_torch.launch.mesh import PRODUCTION, traced_mesh
from repro_torch.models.transformer import serve_mesh_refusal
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro" or n.startswith("repro."))
assert not bad, bad
print("ok", len(names))
"""


def test_port_imports_no_jax_and_no_repro():
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        hits = IMPORT_FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
