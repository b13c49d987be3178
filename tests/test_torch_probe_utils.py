"""The port's probes and quantities of interest, grid extras, study
database, timers and futures pools against the JAX package's.

The JAX package's own tests of these (``tests/test_aux_components.py``)
run here on the port's classes; where both packages compute, they are held
to each other: the grid's ``n_pixels``, ``cell_midpoints`` and
``cell_areas`` exactly, the ``Probe`` matrix and the ``QOI`` functionals
to 1e-14, a ``QOI.extract`` through the profile to 1e-14, and a
``ParameterStudy`` file written by either package loads in the other with
equal contents.
"""

import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu import utils as jutils
from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.fem import Probe, QOI
from generative_physics_informed_pde_tpu_torch.parallel import (
    DummyProcessPool, ThreadPool)
from generative_physics_informed_pde_tpu_torch.utils import (
    ParallelStudyPoolBoy, ParameterStudy, ResultsDatabase, StopWatch, Timer,
    ensure_file_extension)

F64 = torch.float64


@pytest.mark.parametrize("nx,ny,lx,ly", [(8, 8, 1.0, 1.0), (5, 3, 2.0, 0.5),
                                         (16, 16, 1.0, 1.0)])
def test_grid_extras_equal_jax(nx, ny, lx, ly):
    g, j = fem.StructuredTriGrid(nx, ny, lx, ly), \
        jfem.StructuredTriGrid(nx, ny, lx, ly)
    assert g.n_pixels == j.n_pixels == nx * ny
    np.testing.assert_array_equal(g.cell_midpoints, j.cell_midpoints)
    np.testing.assert_array_equal(g.cell_areas, j.cell_areas)
    np.testing.assert_allclose(g.cell_areas.sum(), lx * ly, rtol=1e-14)


def test_probe_exact_for_p1_fields():
    grid = fem.StructuredTriGrid(8, 8)
    pts = np.array([[0.13, 0.77], [0.5, 0.5], [0.99, 0.01]])
    probe = Probe(grid, pts)
    # linear field is reproduced exactly by P1 interpolation
    u = torch.as_tensor(1.0 + 2.0 * grid.node_coords[:, 0]
                        - 0.5 * grid.node_coords[:, 1])
    got = probe(u).numpy()
    expect = 1.0 + 2.0 * pts[:, 0] - 0.5 * pts[:, 1]
    np.testing.assert_allclose(got, expect, rtol=1e-12)
    # batched
    U = torch.stack([u, 2 * u])
    assert probe(U).shape == (2, 3)
    # the JAX package's probe: the same matrix and values
    jprobe = jfem.Probe(jfem.StructuredTriGrid(8, 8), pts)
    np.testing.assert_allclose(probe.matrix, jprobe.matrix, rtol=1e-14,
                               atol=1e-14)
    np.testing.assert_allclose(
        probe(U).numpy(), np.asarray(jprobe(jnp.asarray(U.numpy()))),
        rtol=1e-14, atol=1e-14)


def test_qoi_point_and_subdomain():
    grid = fem.StructuredTriGrid(8, 8)
    qoi_pt = QOI(grid, mx=0.25, my=0.75)
    u = torch.as_tensor(grid.node_coords[:, 0])
    np.testing.assert_allclose(float(qoi_pt.extract(u)), 0.25, rtol=1e-12)
    # subdomain integral of u=1 over |x-.5|<=.25, |y-.5|<=.25 => area 0.25
    qoi_int = QOI(grid, mx=0.5, my=0.5, L=0.25)
    ones = torch.ones(grid.n_nodes, dtype=F64)
    np.testing.assert_allclose(float(qoi_int.extract(ones)), 0.25,
                               rtol=1e-10)
    # restricted + scatter path
    prof = fem.DirichletProfile(grid)
    y_free = u[torch.as_tensor(prof.free_dofs)][None, :]
    bcv = torch.as_tensor(prof.constrained_values(
        np.array([[0.0, 0.0, 1.0, 1.0]])))
    np.testing.assert_allclose(
        qoi_pt.extract(y_free, bc_values=bcv, profile=prof).numpy(), [0.25],
        rtol=1e-10)


@pytest.mark.parametrize("n,mx,my,L", [(8, 0.25, 0.75, None),
                                       (16, 0.5, 0.5, None),
                                       (8, 0.5, 0.5, 0.25),
                                       (12, 0.3, 0.6, 0.2)])
def test_qoi_functionals_and_extract_equal_jax(n, mx, my, L):
    grid, jgrid = fem.StructuredTriGrid(n, n), jfem.StructuredTriGrid(n, n)
    q, jq = QOI(grid, mx=mx, my=my, L=L), jfem.QOI(jgrid, mx=mx, my=my, L=L)
    np.testing.assert_allclose(q.functional, jq.functional, rtol=1e-14,
                               atol=1e-14)
    prof, jprof = fem.DirichletProfile(grid), jfem.DirichletProfile(jgrid)
    rng = np.random.default_rng(n)
    Y = rng.standard_normal((5, prof.n_free))
    theta = rng.uniform(-1, 1, (5, 4))
    got = q.extract(torch.as_tensor(Y), profile=prof, bc_values=torch.as_tensor(
        prof.constrained_values(theta)))
    want = jq.extract(jnp.asarray(Y), profile=jprof,
                      bc_values=jprof.constrained_values(jnp.asarray(theta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14)


def test_parameter_study(tmp_path):
    study = ParameterStudy([("n", int), ("lr", float)])
    study.accumulate((4, 0.1), {"err": 1.0})
    study.accumulate((4, 0.1), {"err": 0.9})
    study.accumulate((8, 0.1), {"err": 0.5})
    assert study.num_results((4, 0.1)) == 2
    assert (4, 0.1) in study and (16, 0.1) not in study
    with pytest.raises(TypeError):
        study.accumulate((4.5, 0.1), {})
    sl = study.slice(lr=0.1)
    assert len(sl) == 2
    study.notify_about_error_from_key((8, 0.1), ValueError("boom"))
    assert study.num_errors == 1
    path = str(tmp_path / "study.json")
    study.save(path)
    study2 = ParameterStudy.load(path)
    assert study2.get((4, 0.1)) == study.get((4, 0.1))
    assert study2.num_errors == 1

    other = ParameterStudy([("n", int), ("lr", float)])
    other.accumulate((16, 0.2), {"err": 0.1})
    study.merge(other)
    assert (16, 0.2) in study


def _study_contents(s):
    return (s.parameter_names, {k: s.get(k) for k in s.keys()},
            {k: s.errors(k) for k in s._errors}, s.num_errors)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parameter_study_files_move_between_packages(tmp_path, writer):
    """A study saved by either package loads in the other with equal
    contents: keys, results (numpy and torch scalars and arrays written as
    JSON numbers and lists), errors."""
    classes = {"jax": jutils.ParameterStudy, "port": ParameterStudy}
    reader = "port" if writer == "jax" else "jax"
    study = classes[writer]([("corrlength_x100", int), ("tag", str)])
    for i, l in enumerate((4, 8, 16)):
        study.accumulate((l, "a"), {"qoi_mean": 0.5 + i / 10,
                                    "n": np.int64(i),
                                    "p": np.float32(0.25) * i,
                                    "v": np.arange(3.0) * i})
    study.accumulate((8, "a"), {"qoi_mean": 0.1})
    study.notify_about_error_from_key((32, "b"), RuntimeError("diverged"))
    path = str(tmp_path / "study.json")
    study.save(path)
    back = classes[reader].load(path)
    again = classes[writer].load(path)
    assert _study_contents(back) == _study_contents(again)
    assert back.get((8, "a"))[1] == {"qoi_mean": 0.1}
    assert back.get((16, "a"))[0]["v"] == [0.0, 2.0, 4.0]
    assert back.errors((32, "b")) == ["RuntimeError('diverged')"]
    # the port also writes torch values as JSON numbers and lists
    if writer == "port":
        study.accumulate((4, "a"), {"t": torch.tensor([1.5, 2.5]),
                                    "s": torch.tensor(3.0)})
        study.save(path)
        assert jutils.ParameterStudy.load(path).get((4, "a"))[1] == {
            "t": [1.5, 2.5], "s": 3.0}


def test_results_database(tmp_path):
    db = ResultsDatabase()
    db.add_result("a", 1.5)
    assert not db.check_complete("a")
    db.mark_complete("a")
    assert db.check_complete("a")
    with pytest.raises(KeyError):
        db.mark_complete("zzz")
    path = str(tmp_path / "db.json")
    db.save(path)
    db2 = ResultsDatabase.load(path)
    assert db2.get_result("a") == 1.5 and db2.check_complete("a")
    db3 = jutils.ResultsDatabase.load(path)
    assert db3.get_result("a") == 1.5 and db3.check_complete("a")


def test_pool_boy_collects_with_failures(tmp_path):
    study = ParameterStudy([("i", int)])

    def work(i):
        if i == 2:
            raise RuntimeError("fail")
        return i * i

    with DummyProcessPool() as pool:
        jobs = [((i,), pool.submit(work, i)) for i in range(4)]
        boy = ParallelStudyPoolBoy(study, save_path=str(tmp_path / "s.json"))
        boy.collect(jobs)
    assert boy.num_failures == 1
    assert study.get((3,)) == [9]
    assert study.errors((2,))
    assert ParameterStudy.load(str(tmp_path / "s.json")).get((3,)) == [9]

    with ThreadPool(MAXWORKERS=2) as pool:
        jobs = [((i,), pool.submit(work, i)) for i in (0, 1)]
        boy = ParallelStudyPoolBoy(ParameterStudy([("i", int)]))
        st = boy.collect(jobs)
    assert st.get((1,)) == [1]


def test_timers():
    sw = StopWatch(start=True)
    time.sleep(0.01)
    assert sw.stop() > 0
    t = Timer(100)
    time.sleep(0.01)
    assert "s" in t.RRT(10)
    t.enter("phase")
    time.sleep(0.01)
    t.exit("phase")
    assert "phase" in t.report()


@pytest.mark.parametrize("path,ext", [("run", "json"), ("run.json", ".json"),
                                      ("a.b", "c"), ("x.npz", "npz")])
def test_ensure_file_extension_equals_jax(path, ext):
    assert ensure_file_extension(path, ext) \
        == jutils.ensure_file_extension(path, ext)


def test_dummy_future_none_result_runs_once():
    """A function legitimately returning None executes exactly once
    across compute()/result()/exception()."""
    calls = []

    def fn():
        calls.append(1)

    pool = DummyProcessPool()
    fut = pool.submit(fn)
    assert fut.result() is None
    assert fut.exception() is None
    assert fut.result() is None
    assert len(calls) == 1, calls


def test_thread_pool_exception_duck_type():
    """With exceptions activated, ThreadPool futures RAISE from
    exception()/compute() like DummyFuture."""
    def boom():
        raise RuntimeError("case failed")

    with ThreadPool(MAXWORKERS=1) as pool:
        fut = pool.submit(boom)          # catching (default)
        assert isinstance(fut.exception(), RuntimeError)
        pool.activate_exceptions()
        fut2 = pool.submit(boom)         # non-catching
        with pytest.raises(RuntimeError, match="case failed"):
            fut2.exception()
        ok = pool.submit(lambda: 42)
        assert ok.result() == 42 and ok.exception() is None
