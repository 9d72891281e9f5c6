"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU.

* A fresh interpreter imports every ``repro_torch`` module and what
  ``chip_smoke.py`` imports; neither ``jax`` nor any ``repro.*`` module
  may then be loaded.
* No source file of the port (nor ``chip_smoke.py``) has an import of
  ``jax`` or ``repro``.
* Without a card, the entry points raise unless the caller passes
  ``device="cpu"``.
* No source file of the port (nor ``chip_smoke.py``) imports a top-level
  module outside the standard library, ``torch``, ``numpy`` and the port
  itself, except under ``try: ... except ImportError`` (an optional
  codec); the card's machine has no ``msgpack`` above all.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch, torch.nn.functional, torch.profiler    # chip_smoke's lazy imports
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(len(mods), ",".join(bad))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", _PROBE,
                        str(ROOT / "chip_smoke.py")], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.strip().split(" ", 1) if " " in r.stdout.strip() \
        else (r.stdout.strip(), "")
    assert int(n) >= 25
    assert bad == "", f"loaded: {bad}"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_repro(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from helpers import GoldenPredictor
    from repro_torch.cli import main as cli_main
    from repro_torch.configs.paper_predictors import PRED_TINY
    from repro_torch.models.schema import init_params
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    params = init_params(PRED_TINY, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelPredictor(params, PRED_TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelPredictor.random_init(PRED_TINY, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompressionService(GoldenPredictor())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["compress", str(ROOT / "README.md"), "/dev/null",
                  "--predictor", "pred-tiny"])
    # the explicit CPU request works
    pred = ModelPredictor(params, PRED_TINY, device="cpu")
    CompressionService(pred, device="cpu")


def test_service_refuses_a_predictor_on_another_device():
    from repro_torch.configs.paper_predictors import PRED_TINY
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    pred = ModelPredictor.random_init(PRED_TINY, seed=0, device="cpu")
    pred.device = torch.device("meta")
    with pytest.raises(ValueError):
        CompressionService(pred, device="cpu")


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """It must exit non-zero and print no result line without a card,
    and outside a checkout (a directory holding only the script)."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    for script in (ROOT / "chip_smoke.py", lone):
        r = subprocess.run([sys.executable, str(script)],
                           cwd=script.parent, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


_ALLOWED = {"torch", "numpy", "repro_torch"}


def _required_imports(path):
    """Top-level modules that ``path`` imports outside an ``except
    ImportError`` guard."""
    tree = ast.parse(path.read_text())
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name) and h.type.id in (
                    "ImportError", "ModuleNotFoundError")
                for h in node.handlers):
            for stmt in node.body:
                guarded.update(id(n) for n in ast.walk(stmt))
    for node in ast.walk(tree):
        if id(node) in guarded:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_source_imports_outside_stdlib_torch_numpy(path):
    for top in _required_imports(ROOT / path):
        assert top in sys.stdlib_module_names or top in _ALLOWED \
            or top == "__future__", f"{path}: imports {top}"


def test_the_mesh_modules_are_among_those_checked():
    """The mesh slice's modules (the mesh and its ranks, the sharding
    policy, the serve steps) are walked by the import probe above and
    have their own source checks."""
    import pkgutil
    import repro_torch
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    for name in ("repro_torch.launch.mesh", "repro_torch.launch.rank_main",
                 "repro_torch.sharding.specs", "repro_torch.serve.steps"):
        assert name in mods, name
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        assert path.is_file()
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_the_training_mesh_modules_are_among_those_checked():
    """Training on a mesh and its driver (the differentiable
    collectives, ``launch/train.py``) are walked by the import probe
    above and have their own source checks; the driver's ranks import
    the port alone."""
    import pkgutil
    import repro_torch
    mods = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")}
    for name in ("repro_torch.launch.collectives",
                 "repro_torch.launch.train",
                 "repro_torch.train.train_loop",
                 "repro_torch.train.checkpoint"):
        assert name in mods, name
        path = ROOT / "src" / (name.replace(".", "/") + ".py")
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.launch.train as t, "
         "repro_torch.launch.collectives\n"
         "bad = [k for k in sys.modules if k.split('.')[0] in "
         "('jax', 'jaxlib', 'repro')]\n"
         "print(','.join(bad))"],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "", r.stdout + r.stderr
