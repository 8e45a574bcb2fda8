"""``repro_torch`` stands alone: no JAX, nothing of ``repro``.

Every module of the port is imported in a fresh interpreter where
``import jax`` fails (``sys.modules["jax"] = None``); afterwards no
module named ``repro`` or ``repro.*`` may be loaded.  The entry points
also refuse to fall back to the CPU quietly: without a card and without
an explicit ``device`` they raise.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(*names)
print(len(names))
"""

_NO_CARD = r"""
import sys
sys.modules["jax"] = None
import torch
assert not torch.cuda.is_available()
from repro_torch import flow, resolve_device
from repro_torch.convert import to_tensor
from repro_torch.core import ref
from repro_torch.core.arch import default_chip
from repro_torch.core.simulator import Simulator
from repro_torch.explore import FleetEvaluator
art = flow.compile("tiny_cnn", default_chip(),
                   flow.CompileOptions(batch=1, workload_kw={"res": 8}))
isa = art.ensure_model().isa
calls = [resolve_device,
         lambda: ref.random_init(art.cg),
         lambda: to_tensor([1, 2]),
         lambda: art.evaluate("func:torch"),
         lambda: Simulator(art.chip, isa),
         lambda: Simulator(art.chip, isa, engine="torch"),
         lambda: art.evaluate("simulate"),
         lambda: art.evaluate("simulate", engine="torch"),
         lambda: FleetEvaluator(art.cg)]
# only the host engines, asked for by name, need no device
assert art.evaluate("simulate", engine="vector").cycles > 0
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError(f"{call} ran without a card")
print("raised", len(calls))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


_SIM_MODULES = ["core.isa", "core.oplevel", "core.codegen", "core.trace",
                "core.vectorsim", "core.simulator", "core.torchsim",
                "explore", "explore.fleet"]


def test_imports_no_jax_no_repro():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    walked = proc.stdout.split()
    assert int(walked[-1]) >= 30                  # every module walked
    for mod in _SIM_MODULES:
        assert f"repro_torch.{mod}" in walked, mod


def test_entry_points_raise_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points use it")
    proc = _run(_NO_CARD)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "9"


def test_package_source_names_no_jax_or_repro():
    """A static check beside the dynamic one: no import line of the
    port names ``jax`` or the ``repro`` package."""
    bad = []
    for path in (SRC / "repro_torch").rglob("*.py"):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if not s.startswith(("import ", "from ")):
                continue
            mod = s.split()[1]
            if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{n}: {s}")
    assert not bad, bad
