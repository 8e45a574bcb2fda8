"""``repro_torch`` stands alone: no JAX, nothing of ``repro``.

Every module of the port is imported in a fresh interpreter where
``import jax`` fails (``sys.modules["jax"] = None``); afterwards no
module named ``repro`` or ``repro.*`` may be loaded.  The same holds
for ``python -m repro_torch.explore``, ``python -m repro_torch.serve``,
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train`` and a flow disk cache that the
JAX package wrote into.  The entry
points also refuse to fall back to the CPU quietly: without a card and
without an explicit ``device`` they raise.
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
from repro_torch.explore import (ExplorationEngine, FleetEvaluator,
                                 DesignPoint, cli, evaluate_chip)
from repro_torch.faults import degradation_curve
from repro_torch.serve import ServeModelCfg, StepCostTable
from repro_torch.serve.__main__ import main as serve_main
from repro_torch.system import SystemConfig
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.convert import from_jax_params
from repro_torch.launch import steps
from repro_torch.launch.serve import main as lm_serve_main
from repro_torch.launch.train import main as lm_train_main
from repro_torch.models import model_zoo, transformer as T
import warnings
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro_torch.core import dse
art = flow.compile("tiny_cnn", default_chip(),
                   flow.CompileOptions(batch=1, workload_kw={"res": 8}))
isa = art.ensure_model().isa
tiny = dict(n_layers=1, d_model=64, n_heads=2, vocab=64, max_prompt=8,
            max_new=8)
lm = reduced(ARCHS["phi4-mini-3.8b"])
calls = [resolve_device,
         lambda: ref.random_init(art.cg),
         lambda: to_tensor([1, 2]),
         lambda: art.evaluate("func:torch"),
         lambda: Simulator(art.chip, isa),
         lambda: Simulator(art.chip, isa, engine="torch"),
         lambda: art.evaluate("simulate"),
         lambda: art.evaluate("simulate", engine="torch"),
         lambda: FleetEvaluator(art.cg),
         lambda: ExplorationEngine("tiny_cnn", res=8),
         lambda: ExplorationEngine("tiny_cnn", engine="torch", res=8),
         lambda: evaluate_chip(art.cg, default_chip(), "dp",
                               fidelity="simulate"),
         lambda: cli.main(["sweep", "tiny_cnn", "--res", "8",
                           "--no-cache"]),
         lambda: degradation_curve(art.cg, default_chip(), [0.0]),
         lambda: flow.calibrate(["tiny_cnn"], default_chip()),
         lambda: dse.sweep_mg_flit(art.cg),
         lambda: flow.compile("tiny_cnn", default_chip(),
                              flow.CompileOptions(
                                  batch=1, workload_kw={"res": 8},
                                  system=SystemConfig.mesh(2))
                              ).evaluate("simulate"),
         lambda: StepCostTable(ServeModelCfg(**tiny), fidelity="simulate"),
         lambda: serve_main(["--fidelity", "simulate", "--chips", "2",
                             "--n-layers", "1", "--d-model", "64",
                             "--n-heads", "2", "--vocab", "64",
                             "--max-prompt", "8", "--max-new", "8"]),
         lambda: lm_serve_main([]),
         lambda: lm_serve_main(["--reduced"]),
         lambda: T.init_params(lm, torch.Generator()),
         lambda: T.init_decode_state(lm, None, 1, 8),
         lambda: steps.make_decode_step(lm, None,
                                        ShapeConfig("t", 8, 1, "decode")),
         lambda: model_zoo.init(lm),
         lambda: from_jax_params(lm, {}),
         lambda: lm_train_main([]),
         lambda: lm_train_main(["--reduced"]),
         lambda: steps.make_train_step(lm, None,
                                       ShapeConfig("t", 8, 1, "train"))]
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
_EXPLORE_MODULES = ["core.dse", "explore.space", "explore.records",
                    "explore.pareto", "explore.cache", "explore.engine",
                    "explore.search", "explore.cli", "explore.__main__",
                    "flow.diskcache", "flow.calibrate", "faults",
                    "faults.model", "faults.metrics", "faults.evaluate"]
_SYSTEM_SERVE_MODULES = ["system", "system.config", "system.partition",
                         "system.passes", "system.evaluate",
                         "system.artifact", "serve", "serve.bucketing",
                         "serve.rng", "serve.metrics", "serve.policy",
                         "serve.workload", "serve.engine",
                         "serve.trace_replay", "serve.__main__"]
_LM_MODULES = ["configs", "configs.base", "configs.phi4_mini_3_8b",
               "configs.mamba2_780m", "data", "data.pipeline", "quant",
               "quant.quantize", "kernels.ops", "kernels.decode_attention",
               "kernels.ssd_decode", "kernels.ssd_scan",
               "kernels.causal_conv", "kernels.gated_norm",
               "kernels.gated_norm_sm90", "kernels.ssm_decode",
               "kernels.triton_source",
               "kernels.nvcc", "models",
               "models.analysis_flags", "models.layers", "models.ssm",
               "models.transformer", "models.model_zoo", "launch",
               "launch.tuning", "launch.meshctx", "launch.steps",
               "launch.serve"]
_TRAIN_MODULES = ["tree", "optim", "optim.adamw", "optim.schedule",
                  "checkpoint", "checkpoint.manager", "runtime",
                  "runtime.straggler", "runtime.fault", "runtime.elastic",
                  "launch.train", "kernels.cross_entropy", "kernels.adamw"]
_MOE_MODULES = ["models.moe_ep", "kernels.grouped_gemm", "launch.mesh"]


def test_imports_no_jax_no_repro():
    proc = _run(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    walked = proc.stdout.split()
    assert int(walked[-1]) >= 60                  # every module walked
    for mod in (_SIM_MODULES + _EXPLORE_MODULES + _SYSTEM_SERVE_MODULES
                + _LM_MODULES + _TRAIN_MODULES + _MOE_MODULES):
        assert f"repro_torch.{mod}" in walked, mod


def test_entry_points_raise_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points use it")
    proc = _run(_NO_CARD)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "29"


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


_CLI_HELP = r"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["repro_torch.explore", "--help"]
try:
    runpy.run_module("repro_torch.explore", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("help ok")
"""


def test_explore_cli_help_without_jax_or_repro():
    proc = _run(_CLI_HELP)
    assert proc.returncode == 0, proc.stderr
    assert "python -m repro_torch.explore" in proc.stdout
    assert "--engine" in proc.stdout and "--device" in proc.stdout
    assert proc.stdout.split()[-2:] == ["help", "ok"]
    main = subprocess.run([sys.executable, "-m", "repro_torch.explore",
                           "--help"], capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert main.returncode == 0 and "sweep" in main.stdout, main.stderr


_SERVE_HELP = r"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["repro_torch.serve", "--help"]
try:
    runpy.run_module("repro_torch.serve", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print("help ok")
"""


_LM_SERVE_HELP = r"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["repro_torch.launch.serve", "--help"]
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "triton" or m.startswith("triton."))
assert not leaked, leaked
print("help ok")
"""


def test_lm_serve_cli_help_without_jax_repro_or_triton():
    proc = _run(_LM_SERVE_HELP)
    assert proc.returncode == 0, proc.stderr
    assert "python -m repro_torch.launch.serve" in proc.stdout
    assert "--arch" in proc.stdout and "--device" in proc.stdout
    assert proc.stdout.split()[-2:] == ["help", "ok"]


_LM_TRAIN_HELP = _LM_SERVE_HELP.replace("launch.serve", "launch.train")


def test_lm_train_cli_help_without_jax_repro_or_triton():
    proc = _run(_LM_TRAIN_HELP)
    assert proc.returncode == 0, proc.stderr
    assert "python -m repro_torch.launch.train" in proc.stdout
    assert "--ckpt-dir" in proc.stdout and "--device" in proc.stdout
    assert proc.stdout.split()[-2:] == ["help", "ok"]


def test_serve_cli_help_without_jax_or_repro():
    proc = _run(_SERVE_HELP)
    assert proc.returncode == 0, proc.stderr
    assert "python -m repro_torch.serve" in proc.stdout
    assert "--chips" in proc.stdout and "--device" in proc.stdout
    assert proc.stdout.split()[-2:] == ["help", "ok"]


_PORT_ON_REFERENCE_CACHE = r"""
import sys
sys.modules["jax"] = None
from repro_torch import flow
from repro_torch.core.arch import default_chip
pipe = flow.Pipeline(disk_cache=sys.argv[1])
pipe.compile("tiny_cnn", default_chip(), flow.CompileOptions(
    strategy="dp", batch=2, workload_kw={"res": 8}))
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print(pipe.disk.hits, pipe.disk.misses, len(pipe.disk))
"""


def test_reference_disk_cache_entries_never_loaded(tmp_path):
    """The JAX package's pickles under the port's very pass keys, in the
    port's cache directory: the port misses them and imports nothing of
    ``repro`` (or of JAX) while compiling."""
    from repro import flow as jflow
    from repro.core.arch import default_chip as j_default_chip
    root = str(tmp_path / "flow")
    jpipe = jflow.Pipeline(disk_cache=root)
    jpipe.compile("tiny_cnn", j_default_chip(), jflow.CompileOptions(
        strategy="dp", batch=2, workload_kw={"res": 8}))
    assert len(jpipe.disk) == 2
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PORT_ON_REFERENCE_CACHE,
                           root], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0", "2", "2"]
