"""The port's spans (``utils.time.span``) on the CPU.

Without a profiler a span records nothing and enters no
``record_function``; under ``torch.profiler`` the spans nest under one
root per solve, pool and step, their ``gpipde.*`` names appear in the
profiler's table, and their counts match the counters the port already
keeps (PCG iterations, label dispatches, V-cycles).  The benchmark's
readers of the spans (``portbench/layer_metrics/``) run on the harness's
small stand-in cells (``portbench/tests/tiny.py``, cut further), each in
a child process started with the module: the harness refuses to run in a
process that loaded JAX, as this one has.  Grids of 16^2 and 32^2.

Run as a script (``--child CELL``) it is such a child: it runs the cell
traced and prints its result line's metrics and a summary of the spans.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import generative_physics_informed_pde_tpu_torch.utils.time as spans
from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.fem.assembly import (
    StencilOperator)
from generative_physics_informed_pde_tpu_torch.fem.batched_solver import (
    make_batched_fom_solver)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ("loader_host_ms.label", "pcg_enqueue_ms.label",
           "host_syncs.label", "host_syncs.sweep", "step_host_ms.train")
CELLS = ("c5-sweep", "c3-label", "c3-train")


# ------------------------------------------------------------ the children
def _stand_in(cell: str):
    """tiny.py's stand-in of ``cell``, cut to a few seconds traced."""
    from portbench.tests import tiny

    cfg, tr = tiny.CELLS[cell]()
    if cell == "c5-sweep":
        cfg["fields_per_case"] = 2
    elif cell == "c3-label":
        cfg["model"].update(grid=16, num_refines=2)
        tr.update(pool=4)
    else:
        tr.update(checked_steps=1, traced_iterations=1)
    return cfg, tr


def _child(cell: str):
    import copy

    torch.set_num_threads(1)
    from portbench import run
    from portbench.tests import tiny

    cfg, tr = _stand_in(cell)
    spans.reset_spans()
    _, ctx, out = run.execute(cell, 2 ** 33 + 5, 0.01, True, device="cpu",
                              bench=copy.deepcopy(tiny.BENCH), config=cfg,
                              traffic=tr)
    recs = spans.span_records()
    by_id = {r.id: r for r in recs}
    print(json.dumps({
        "correct": out["correct"], "metrics": out["metrics"],
        "iterations": ctx.traced["iterations"],
        "roots": sorted(r.name for r in recs if r.parent is None),
        "under": sorted({(r.name, by_id[r.parent].name,
                          by_id[r.root].name)
                         for r in recs if r.parent is not None})}))


@pytest.fixture(scope="module", autouse=True)
def stand_in_runs():
    """The three stand-in cells, each run traced in a child process that
    starts with the module (so they run while the tests below do)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {c: subprocess.Popen(
        [sys.executable, __file__, "--child", c], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in CELLS}
    results = {}

    def result(cell):
        if cell not in results:
            try:
                out, err = procs[cell].communicate(timeout=150)
            except subprocess.TimeoutExpired:
                procs[cell].kill()
                out, err = procs[cell].communicate()
            assert procs[cell].returncode == 0, err[-3000:]
            results[cell] = json.loads(out.strip().splitlines()[-1])
        return results[cell]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


# ----------------------------------------------------------------- helpers
@pytest.fixture(scope="module")
def physics():
    """'NDP' physics on a 16^2 fine grid (a 4^2 ROM refined twice): the
    'auto' gate picks Jacobi, here stopped at 1e-3 (~40 iterations)."""
    return fem.make_fom_rom_pair("NDP", 4, 4, 2, device="cpu", cg_tol=1e-3)


def _fields(n: int, seed: int) -> np.ndarray:
    return 0.5 * np.random.default_rng(seed).standard_normal((n, 16, 16))


def _traced(fn):
    """``fn()`` under a CPU profiler -> (its result, the span records, the
    profiler)."""
    spans.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    return got, spans.span_records(), prof


def _keys(prof) -> set:
    return {k.key for k in prof.key_averages()}


def _check_tree(recs):
    """Every span lies inside its parent, on its parent's thread, under
    its parent's root; -> {id: record}."""
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is None:
            assert r.root == r.id
            continue
        p = by_id[r.parent]
        assert (p.root, p.thread) == (r.root, r.thread)
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    return by_id


# ------------------------------------------------------------------- tests
def test_off_makes_no_record_and_enters_no_record_function(monkeypatch,
                                                           physics):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    spans.reset_spans()
    assert not torch.autograd._profiler_enabled()
    assert spans.span("a") is spans.span("mg.level3")
    DataLoader(_fields(6, 0)).assemble(physics, label_batch=8)
    assert spans.span_records() == [] and spans.span_totals() == {}
    assert entered == []


def test_pool_spans_nest_under_one_root_a_pool(physics):
    def pools():
        out = []
        for seed in (1, 2):
            dl = DataLoader(_fields(12, seed))
            dl.assemble(physics, label_batch=8)  # two dispatches, one padded
            out.append(dl)
        return out

    dls, recs, _ = _traced(pools)
    by_id = _check_tree(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["loader.assemble"] * 2
    under = {(r.name, by_id[r.parent].name) for r in recs if r.parent}
    assert under == {(n, "loader.assemble") for n in (
        "loader.bce", "loader.prepare", "loader.readback", "loader.rom_bc",
        "solve")} | {(n, "solve") for n in (
            "solve.setup", "pcg.stop_check", "pcg.iteration")}
    tot = spans.span_totals()
    dispatches = sum(len(dl.label_iterations) for dl in dls)
    assert dispatches == 4
    assert tot["loader.readback"]["calls"] == dispatches
    assert tot["loader.prepare"]["calls"] == 2 + dispatches
    assert tot["pcg.stop_check"]["calls"] == sum(
        i + 1 for dl in dls for i in dl.label_iterations)
    for t in tot.values():
        assert 0 <= t["self_s"] <= t["host_s"]
    assert tot["loader.assemble"]["self_s"] < tot["loader.assemble"]["host_s"]


def test_stop_checks_are_iterations_plus_one_in_a_jacobi_solve(physics):
    fom = physics["fom"]
    X = torch.as_tensor(_fields(5, 3))
    a = torch.exp(fom.pixels.image_to_function(X))
    v = torch.ones((5, len(fom.constrained_dofs)), dtype=torch.float64)
    _, recs, _ = _traced(lambda: fom.solve_batched(a, v))
    _check_tree(recs)
    assert fom._batched_solver.mg is None
    tot = spans.span_totals()
    assert tot["pcg.stop_check"]["calls"] == fom.last_iterations + 1
    assert tot["pcg.iteration"]["calls"] == fom.last_iterations
    assert [r.name for r in recs if r.parent is None] == ["solve"]


def test_span_names_appear_in_the_profilers_table(physics):
    dl, recs, prof = _traced(lambda: DataLoader(_fields(3, 6)).assemble(
        physics, label_batch=8))
    names = {r.name for r in recs}
    assert names == {"loader.assemble", "loader.bce", "loader.prepare",
                     "loader.readback", "loader.rom_bc", "solve",
                     "solve.setup", "pcg.stop_check", "pcg.iteration"}
    assert {"gpipde." + n for n in names} <= _keys(prof)


def test_each_vcycle_level_runs_once_a_cycle():
    grid = fem.StructuredTriGrid(32, 32)
    solver = make_batched_fom_solver(StencilOperator(grid),
                                     fem.DirichletProfile(grid),
                                     precond="mg")
    L = solver.mg.num_levels
    assert L == 4
    rng = np.random.default_rng(4)
    a = torch.as_tensor(np.exp(0.5 * rng.standard_normal(
        (3, grid.n_cells))), dtype=torch.float32)
    v = torch.ones((3, len(solver.con_dofs)), dtype=torch.float32)
    _, recs, _ = _traced(lambda: solver(a, v))
    by_id = _check_tree(recs)
    tot = spans.span_totals()
    cycles = solver.iterations + 1  # one before the loop, one an iteration
    assert {f"mg.level{i}" for i in range(L)} <= set(tot)
    assert f"mg.level{L}" not in tot
    for i in range(L):
        assert tot[f"mg.level{i}"]["calls"] == cycles
    for r in recs:
        if r.name.startswith("mg.level") and r.name != "mg.level0":
            i = int(r.name[len("mg.level"):])
            assert by_id[r.parent].name == f"mg.level{i - 1}"
    assert {by_id[r.parent].name for r in recs if r.name == "mg.level0"} \
        == {"solve", "pcg.iteration"}


def test_adjoint_records_on_autograds_thread_under_its_own_stack(
        monkeypatch, physics):
    # a card's backward runs on autograd's device thread, which carries the
    # profiler's state; a CPU backward runs on the thread that calls it, so
    # a second thread calls it here and the spans are switched on for all
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: True)
    spans.reset_spans()
    fom = physics["fom"]
    X = torch.as_tensor(_fields(3, 5))
    a = torch.exp(fom.pixels.image_to_function(X)).requires_grad_()
    v = torch.ones((3, len(fom.constrained_dofs)), dtype=torch.float64)
    y = fom.solve_batched(a, v)
    grads, worker = [], []

    def backward():
        worker.append(threading.get_ident())
        grads.append(torch.autograd.grad(y.sum(), a)[0])

    with spans.span("test.outer"):
        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and torch.isfinite(grads[0]).all()
    recs = spans.span_records()
    by_id = _check_tree(recs)
    (adj,) = [r for r in recs if r.name == "solve.adjoint"]
    (outer,) = [r for r in recs if r.name == "test.outer"]
    assert adj.thread == worker[0] != outer.thread == threading.get_ident()
    assert adj.parent is None and adj.root == adj.id
    inner = [r for r in recs if r.root == adj.id and r is not adj]
    assert {r.name for r in inner} == {"pcg.stop_check", "pcg.iteration"}
    assert all(r.thread == adj.thread for r in inner)
    assert not any(r.parent == outer.id for r in by_id.values())


@pytest.mark.parametrize("name", READERS)
def test_each_new_reader_reads_its_stand_in_cell(name, stand_in_runs):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    (cell,) = m["workloads"]
    got = stand_in_runs(cell)
    assert got["correct"] and m["source"] == "program_span"
    value = got["metrics"][name]["value"]
    assert np.isfinite(value) and value > 0
    its = got["metrics"].get(f"pcg_iterations.{cell.split('-')[1]}")
    if name == "host_syncs.sweep":
        assert value == its["value"] + 1
    if name == "host_syncs.label":  # one dispatch a pool: its check, read
        assert value == its["value"] + 1 + 1


def test_step_spans_nest_under_one_root_a_step(stand_in_runs):
    got = stand_in_runs("c3-train")
    assert got["roots"] == ["trainer.step"] * got["iterations"]
    under = {tuple(u) for u in got["under"]}
    assert {root for _, _, root in under} == {"trainer.step"}
    assert {(n, p) for n, p, _ in under} >= {
        (n, "trainer.step") for n in ("trainer.elbo", "trainer.backward",
                                      "trainer.optimizer", "trainer.logs")
    } | {("rom.solve", "trainer.elbo")}


def test_sweep_and_pool_spans_have_one_root_each(stand_in_runs):
    sweep, label = stand_in_runs("c5-sweep"), stand_in_runs("c3-label")
    assert sweep["roots"] == ["solve"] * sweep["iterations"]
    assert label["roots"] == ["loader.assemble"] * label["iterations"]
    assert ("mg.level1", "mg.level0", "solve") in {
        tuple(u) for u in sweep["under"]}


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(sys.argv[2])
