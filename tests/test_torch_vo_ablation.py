"""``examples/torch_vo_ablation.py`` against the JAX package's
``examples/vo_ablation.py``.

- ``_params`` equals the JAX example's for every arm and option (the JAX
  example imported by path, its module never run).
- The results file accumulates as the JAX example's does: the same rows
  for the same runs (both ``main``s driven with one stand-in ``run_arm``
  in a temporary directory), and the port's tagging of a result row for
  each option.
- Each arm trains 2 steps on the CPU at a shrunken size (8 labeled, 8 VO,
  8 validation, 16 unlabeled fields, batch 8, labels in dispatches of 8,
  a 1 x 3 final refinement and 8 final Monte-Carlo samples) with finite
  metrics, and writes nothing.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import torch_vo_ablation as abl  # noqa: E402

ARMS = ("labels", "constrain", "energy")


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_vo_ablation", ROOT / "examples" / "vo_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_abl():
    return _jax_example()


@pytest.mark.parametrize("arm", ARMS)
def test_params_equal_the_jax_example(arm, jax_abl):
    for iterations in (4000, 40, 7):
        for n_s in (64, 0, 16):
            for cadence in (None, 10):
                for temper in (1.0, 0.5):
                    got = vars(abl._params(iterations, arm, n_s, cadence,
                                           temper))
                    want = vars(jax_abl._params(iterations, arm, n_s,
                                                cadence, temper))
                    assert got == want, (arm, iterations, n_s, cadence,
                                         temper)
    with pytest.raises(ValueError):
        abl._params(10, "neither", 64)


def _stub_run_arm(tagged):
    """A ``run_arm`` that trains nothing: a row of made-up metrics,
    tagged by ``tagged``."""
    def run_arm(arm, iterations, n_s=64, vo_cadence=None, corrlength=0.04,
                temper=1.0, **_):
        x = len(arm) + iterations / 1000 + n_s
        return tagged({"relerr_y": x, "r2_y": -x, "logscore_y": 2 * x,
                       "runtime": 1.0, "arm": arm, "iterations": iterations,
                       "N_s": n_s, "steps_per_sec": 10.0},
                      vo_cadence, temper, corrlength)
    return run_arm


RUNS = (["40", "labels"], ["40", "constrain", "--cadence", "10"],
        ["50", "constrain", "--cadence", "10"],
        ["40", "energy", "--ns", "0"], ["40", "constrain", "--temper", "0.5",
                                        "--corrlength", "0.15"],
        ["60", "labels"])


def test_results_accumulate_as_the_jax_example(jax_abl, tmp_path,
                                               monkeypatch, capsys):
    monkeypatch.setattr(abl, "run_arm", _stub_run_arm(abl._tagged))
    port = tmp_path / "port.json"
    for argv in RUNS:
        abl.main(argv, device="cpu", path=str(port))
    # the JAX example reads sys.argv and writes results/vo_ablation.json
    # under the working directory
    monkeypatch.setattr(jax_abl, "run_arm", _stub_run_arm(abl._tagged))
    monkeypatch.chdir(tmp_path)
    for argv in RUNS:
        monkeypatch.setattr(sys, "argv", ["vo_ablation.py", *argv])
        jax_abl.main()
    want = json.loads((tmp_path / "results" / "vo_ablation.json").read_text())
    got = json.loads(port.read_text())
    assert got == want
    assert [r["arm"] for r in got] == [
        "constrain@10", "energy", "constrain*t0.5/l0.15", "labels"]
    assert [r["iterations"] for r in got] == [50, 40, 40, 60]
    assert "rel-L2" in capsys.readouterr().out


def test_result_rows_are_tagged_with_their_options():
    row = {"arm": "constrain", "relerr_y": 1.0}
    assert abl._tagged(row, None, 1.0, 0.04) == row
    assert abl._tagged(row, 10, 0.5, 0.15) == {
        "arm": "constrain@10*t0.5/l0.15", "relerr_y": 1.0,
        "vo_cadence": 10, "temper": 0.5, "corrlength": 0.15}
    # --cadence and --temper change the constrain arm only
    assert abl._tagged({"arm": "energy"}, 10, 0.5, 0.04) == {"arm": "energy"}
    assert abl._tagged({"arm": "labels"}, None, 1.0, 0.1) == {
        "arm": "labels/l0.1", "corrlength": 0.1}
    assert abl._tag("labels", 10, 0.5, 0.15) == "labels@10*t0.5/l0.15"


@pytest.fixture
def shrunken(monkeypatch):
    from generative_physics_informed_pde_tpu_torch.data import DataLoader

    class Labeled(DataLoader):
        def assemble(self, *a, **k):
            k.setdefault("label_batch", 8)
            return super().assemble(*a, **k)

    params = abl._params

    def small(*a, **k):
        p = params(*a, **k)
        p.trainer.update(N_PE_updates_final=1,
                         N_monte_carlo_analysis_final=8)
        return p

    monkeypatch.setattr(abl, "N_VO", 8)
    monkeypatch.setattr(abl, "N_VAL", 8)
    monkeypatch.setattr(abl, "N_U", 16)
    monkeypatch.setattr(abl, "BATCH", 8)
    monkeypatch.setattr(abl, "DataLoader", Labeled)
    monkeypatch.setattr(abl, "_params", small)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arm", ARMS)
def test_each_arm_trains_on_the_cpu(arm, shrunken, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = abl.run_arm(arm, 2, n_s=8, device="cpu")
    assert out["arm"] == arm and out["iterations"] == 2 and out["N_s"] == 8
    for k in ("relerr_y", "r2_y", "logscore_y", "steps_per_sec"):
        assert math.isfinite(out[k]), k
    assert list(tmp_path.iterdir()) == []  # run_arm writes nothing


def test_defaults_are_the_published_recipe():
    assert (abl.N_VO, abl.N_VAL, abl.N_U, abl.BATCH) == (64, 64, 1024, 64)
    p = abl._params(4000, "energy", 64)
    assert p.identifier == "highres"
    assert p.data["vo_spec"]["T_iterations"] == 4001
    assert np.isclose(p.scheduler["factor"], math.sqrt(0.1))
    assert abl.RESULTS.endswith("torch_vo_ablation.json")
