"""Hygiene of the port: it, its runners (``examples/torch_*.py``) and
chip_smoke.py import nothing of JAX or the JAX package, its entry points
refuse to fall back to the CPU silently, its files are written only where
the caller says, and chip_smoke.py runs only when executed, and only on a
card."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import generative_physics_informed_pde_tpu_torch as port
from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.serving import SurrogateBundle

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "generative_physics_informed_pde_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "generative_physics_informed_pde_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(files) > 15
    assert {f.name for f in files} >= {"torch_baseline_configs.py",
                                       "torch_train_highres32.py"}
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad


def test_matplotlib_is_imported_inside_functions_only():
    """The card's machine has no matplotlib: no module of the port, no
    runner and not chip_smoke.py imports it at module level (plotting
    imports it inside its functions)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(f.name, n) for n in names
                    if n == "matplotlib" or n.startswith("matplotlib.")]
    assert not bad, bad
    assert "matplotlib" in (PKG / "utils" / "plotting.py").read_text()


def test_constraints_are_covered_and_keep_their_own_flux_copy():
    """The port's constraints/ (virtual observables, flux) is among the
    files checked above and imports no JAX, not even the JAX package's
    pure-numpy flux module: it keeps its own copy."""
    files = sorted((PKG / "constraints").glob("*.py"))
    assert [f.name for f in files] == ["__init__.py", "flux.py",
                                       "virtual_observables.py"]
    for f in files:
        assert not [m for m in _imported_modules(f) if _forbidden(m)], f
    src = (PKG / "constraints" / "flux.py").read_text()
    assert "def _entries" in src and "def assemble_reduced" in src


def test_vo_ensemble_refuses_fields_on_another_device():
    from generative_physics_informed_pde_tpu_torch.constraints import (
        QuerryPointEnsemble)

    phys = fem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    n_cells = phys["fom"].grid.n_cells
    n_con = phys["fom"].constrained_dofs.size
    with pytest.raises(ValueError, match="X_DG is on meta"):
        QuerryPointEnsemble(phys["fom"], torch.zeros(3, n_cells,
                                                     device="meta"),
                            torch.zeros(3, n_con, device="meta"))


def test_every_module_imports_with_jax_blocked():
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', "
            "'generative_physics_informed_pde_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fem.make_fom_rom_pair("NDP", 4, 4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fem.LinearEllipticPhysics("fom", "NDP", fem.StructuredTriGrid(4, 4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        highres32().setup()
    dm = highres32().setup(device="cpu")[2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SurrogateBundle.build(dm, (32, 32), 25)


def test_training_entry_points_raise_without_a_card(monkeypatch):
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.factories import (
        DataFactory)
    from generative_physics_informed_pde_tpu_torch.training import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(highres32())
    preset = DataFactory.FromIdentifier("highres32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preset.setup(N_u_max=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preset.unlabeled(4)
    rf = fem.GaussianRandomField.from_image(4, 4, 0.4, 0.8, 0.15)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rf.sample(batch_size=2)
    dl = DataLoader(rf.sample(batch_size=6, device="cpu").numpy())
    dl.ascending_partition({"a": 3})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dl.construct_dataset_dictionary(identifier="default",
                                        dtype=torch.float32)


def test_importing_chip_smoke_does_not_run_it(capsys):
    sys.path.insert(0, str(ROOT))
    try:
        mod = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    assert callable(mod.main)
    captured = capsys.readouterr()
    assert captured.out == "" and captured.err == ""


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    """Run as a script on a machine without a card -- from the repo, or
    copied alone into an empty directory -- it exits non-zero and prints
    no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _repo_files():
    """(path, size, mtime) of every file in the repo tree, without git's
    own files and bytecode caches."""
    out = set()
    for path in ROOT.rglob("*"):
        parts = path.relative_to(ROOT).parts
        if ".git" in parts or "__pycache__" in parts or not path.is_file():
            continue
        st = path.stat()
        out.add((str(path), st.st_size, st.st_mtime_ns))
    return out


def test_saves_write_only_under_the_given_path(tmp_path):
    """A checkpoint, a surrogate bundle, a metrics file, a dataset file and
    a data preset's dataset cache, each saved under ``tmp_path``, write
    nothing in the repo tree."""
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer, TrainerParameters, save_encoder_decoder)

    rf = fem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    X = rf.sample(torch.Generator().manual_seed(0), batch_size=20,
                  dtype=torch.float64, device="cpu").numpy()
    before = _repo_files()
    p = TrainerParameters()
    p.identifier = "highres32"
    p.folder = str(tmp_path / "logs")
    p.trainer.update(lr_init=1e-2, N_monitor_interval=1, N_PE_updates=1,
                     N_PE_updates_final=1, N_monte_carlo_analysis=4,
                     N_monte_carlo_analysis_final=4)
    p.data.update(N_u=8, N_s=8, N_u_max=8, N_s_max=8, N_val=4,
                  armortized_bs=4)
    dlu = DataLoader(X[12:])
    dlu.lock_physics_assembly()
    dl = DataLoader(X[:12])
    tr = CreateTrainer(p, dl, dlu, device="cpu")
    tr.run(2, verbose=False)
    tr.save_checkpoint(str(tmp_path / "ckpt.pt"))
    save_encoder_decoder(str(tmp_path / "codec.pt"), tr.model)
    tr.export_surrogate(str(tmp_path / "surrogate.zip"), buckets=(4,))
    dl.save(str(tmp_path / "fields.npz"))
    tr.finalize()
    DataFactory = importlib.import_module(
        "generative_physics_informed_pde_tpu_torch.factories.data"
    ).DataFactory

    class Tiny(DataFactory):
        _identifier = "tinycache"
        _N, _N_unsupervised = 4, 3
        _rfs = fem.GaussianRandomField.from_image(8, 8, 0.0, 1.0, 0.3)

    for _ in range(2):  # a miss that writes, then a hit
        Tiny(path=str(tmp_path / "cache") + "/").setup(device="cpu")
    assert _repo_files() == before
    assert {f.name for f in tmp_path.iterdir()} == {
        "logs", "ckpt.pt", "codec.pt", "surrogate.zip", "fields.npz",
        "cache"}
    assert len(list((tmp_path / "cache").iterdir())) == 4
    assert (tmp_path / "logs" / "metrics.jsonl").stat().st_size > 0
