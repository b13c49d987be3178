"""The port's parallel layer (``parallel/``: meshes, batch sharding, device
and process sweeps, ``torch.distributed`` wiring), after the JAX package's
``tests/test_parallel.py``.

JAX forces 8 host devices into one process; PyTorch runs one process per
device, so the single-process tests here run on a one-device mesh, beside
the JAX package's functions on the same inputs (equal returns, equal
raised messages, equal checkpoint part files), and the multi-device
behaviour is checked by one test that starts two gloo processes (this
file run as a script with ``--child``; it imports no JAX and needs no
``tests/conftest.py``).  Both ranks must return the same
results: ``sweep_over_devices`` and ``sweep_over_processes`` equal to the
one-process run exactly, failures reported the same way on every rank,
and the uncertainty sweep (``examples/torch_uncertainty_study.py`` at
16^2, 4 cases x B = 8, its 32 systems split 16 + 16) within rtol 1e-5 /
atol 1e-6 of the one-process sweep (each process stops its PCG on its own
systems; the tolerances of the JAX package's
``test_uncertainty_sweep_sharded_matches_local``).  A sweep whose systems
do not split evenly (3 cases x B = 3 over two processes) raises on both
ranks before any solve, and a device sweep of 3 cases runs whole on each.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))
from generative_physics_informed_pde_tpu_torch import fem, parallel  # noqa: E402
from generative_physics_informed_pde_tpu_torch.parallel import (  # noqa: E402
    batch_pspec, distributed, make_mesh, shard_data_dict, sweep_over_devices,
    sweep_over_processes)

LENGTHS = (0.1, 0.2, 0.3, 0.4)
SIGNALS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these solves are many small ops, which slow
    down by tens of times when every test worker's threads contend for the
    cores; the results do not depend on the thread count here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(*a, **k):
    return make_mesh(*a, device="cpu", **k)


def _jax_parallel():
    """The JAX package's parallel layer, imported inside the tests: the
    two-process children run this file and import nothing of JAX."""
    import generative_physics_informed_pde_tpu.parallel.mesh  # noqa: F401
    from generative_physics_informed_pde_tpu import parallel as jpar

    return jpar


def _numpy(data):
    """``data`` with its tensors as numpy arrays, for the JAX package."""
    from torch.utils import _pytree

    return _pytree.tree_map(np.asarray, data)


def _raised(fn, *args, **kw):
    """(type, message) of what ``fn`` raises."""
    with pytest.raises(Exception) as err:
        fn(*args, **kw)
    return type(err.value), str(err.value)


def _parts(directory):
    """{name: decoded JSON} of the checkpoint part files in ``directory``."""
    return {f.name: json.loads(f.read_text())
            for f in sorted(Path(directory).glob("*.p*.json"))}


def test_make_mesh_and_shardings():
    mesh = _cpu_mesh()
    assert mesh.shape == (1,) and mesh.mesh_dim_names == ("dp",)
    mesh2 = _cpu_mesh(1, ("dp", "mc"), (1, 1))
    assert mesh2.shape == (1, 1) and mesh2.size() == 1
    with pytest.raises(ValueError, match="requested"):
        _cpu_mesh(10 ** 6)
    with pytest.raises(ValueError, match="does not hold"):
        _cpu_mesh(1, ("dp", "mc"), (2, 1))
    data = {"X": np.zeros((16, 4)), "nested": {"Y": torch.ones(8)}}
    sharded = shard_data_dict(data, mesh)
    assert isinstance(sharded["X"], torch.Tensor)
    assert sharded["X"].shape == (16, 4) and sharded["X"].device.type == "cpu"
    assert torch.equal(sharded["nested"]["Y"], torch.ones(8))
    # the JAX package: the same errors, the same values on one device
    jpar = _jax_parallel()
    typ, msg = _raised(jpar.make_mesh, 10 ** 6)
    assert typ is ValueError and msg.startswith("requested 1000000 devices")
    assert _raised(_cpu_mesh, 10 ** 6)[1].startswith(
        "requested 1000000 devices")
    assert _raised(jpar.make_mesh, 1, ("dp", "mc"), (2, 1))[0] is ValueError
    jsh = jpar.shard_data_dict(_numpy(data), jpar.make_mesh(1))
    np.testing.assert_array_equal(np.asarray(jsh["X"]), sharded["X"].numpy())
    np.testing.assert_array_equal(np.asarray(jsh["nested"]["Y"]),
                                  sharded["nested"]["Y"].numpy())


def _case_fn(args):
    return torch.sum(args["a"] ** 2) + args["b"]


def _jcase_fn(args):
    import jax.numpy as jnp

    return jnp.sum(args["a"] ** 2) + args["b"]


def _case_fn_item(args):
    # .item() is refused under vmap: the sweep runs it case by case
    return torch.tensor(float(args["a"].sum().item()) + float(args["b"]))


CASES = {"a": torch.arange(32, dtype=torch.float32).reshape(8, 4),
         "b": torch.arange(8, dtype=torch.float32)}
EXPECT = (np.sum(np.arange(32, dtype=np.float32).reshape(8, 4) ** 2, 1)
          + np.arange(8))


def test_sweep_over_devices():
    out = sweep_over_devices(_case_fn, CASES, mesh=_cpu_mesh())
    np.testing.assert_allclose(out.numpy(), EXPECT)
    # no mesh: this process, on the cases' device; the same values
    assert torch.equal(sweep_over_devices(_case_fn, CASES), out)
    got = sweep_over_devices(_case_fn_item, CASES, mesh=_cpu_mesh())
    np.testing.assert_allclose(
        got.numpy(), CASES["a"].sum(1).numpy() + CASES["b"].numpy())
    # an error that is not vmap's refusal propagates, with no second,
    # case-by-case run
    calls = []

    def failing(args):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        sweep_over_devices(failing, CASES, mesh=_cpu_mesh())
    assert calls == [1]
    # the JAX package on the same cases: one device, its default mesh of
    # all (8) devices, and 3 cases that its mesh keeps whole
    jpar = _jax_parallel()
    jcases = {k: v.numpy() for k, v in CASES.items()}
    odd = {k: v[:3] for k, v in CASES.items()}
    for jmesh in (jpar.make_mesh(1), None):
        np.testing.assert_array_equal(np.asarray(jpar.sweep_over_devices(
            _jcase_fn, jcases, mesh=jmesh)), out.numpy())
    np.testing.assert_array_equal(
        np.asarray(jpar.sweep_over_devices(
            _jcase_fn, {k: v.numpy() for k, v in odd.items()})),
        sweep_over_devices(_case_fn, odd).numpy())


def _flaky(c):
    if c == 1:
        raise ValueError("boom")
    return c * 2


def test_sweep_over_processes_error_semantics():
    """A case that raises is captured (peers must reach the exchange,
    never deadlock on one process's exception), then either re-raised
    uniformly or returned as an ``__error__`` record."""
    with pytest.raises(RuntimeError, match="boom"):
        sweep_over_processes(_flaky, [0, 1, 2])
    recs = sweep_over_processes(_flaky, [0, 1, 2], return_exceptions=True)
    assert recs[0] == 0 and recs[2] == 4
    assert "__error__" in recs[1] and "boom" in recs[1]["__error__"]
    # the JAX package's sweep: the same records and the same message
    jpar = _jax_parallel()
    assert jpar.sweep_over_processes(_flaky, [0, 1, 2],
                                     return_exceptions=True) == recs
    assert _raised(jpar.sweep_over_processes, _flaky, [0, 1, 2]) \
        == _raised(sweep_over_processes, _flaky, [0, 1, 2])


def _kill_and_resume(sweep, tmp):
    """A sweep killed at case 3 of 6, resumed; a sweep with a failing case,
    resumed.  Returns what each step ran and returned, and the part files
    after each step."""
    tmp.mkdir()
    ckpt, ckpt2 = str(tmp / "sweep"), str(tmp / "sweep2")
    rec, runs = {}, []

    def fn(c):
        runs.append(c)
        if c == 3:  # the "kill": an uncatchable interrupt mid-sweep
            raise KeyboardInterrupt
        return {"val": c * 10}

    with pytest.raises(KeyboardInterrupt):
        sweep(fn, list(range(6)), checkpoint_path=ckpt, save_interval_s=0.0)
    rec["runs_killed"], rec["parts_killed"] = list(runs), _parts(tmp)

    def fn2(c):
        runs.append(c)
        return {"val": c * 10}

    rec["out"] = sweep(fn2, list(range(6)), checkpoint_path=ckpt,
                       save_interval_s=0.0)
    rec["runs"], rec["parts_resumed"] = list(runs), _parts(tmp)

    def fn3(c):
        if c == 1:
            raise ValueError("flaky")
        return {"val": c}

    rec["recs"] = sweep(fn3, [0, 1, 2], checkpoint_path=ckpt2,
                        save_interval_s=0.0, return_exceptions=True)
    rec["parts_failed"] = _parts(tmp)
    rec["out2"] = sweep(lambda c: {"val": c}, [0, 1, 2],
                        checkpoint_path=ckpt2, save_interval_s=0.0)
    rec["parts"] = _parts(tmp)
    rec["files"] = sorted(p.name for p in tmp.iterdir())
    return rec


def test_sweep_over_processes_kill_and_resume(tmp_path):
    """A sweep killed mid-way loses nothing: re-running with the same
    checkpoint_path skips every durably completed case, retries failures,
    and returns the full result list; the JAX package's sweep runs the
    same cases, returns the same and leaves the same part files."""
    rec = _kill_and_resume(sweep_over_processes, tmp_path / "port")
    assert rec["runs_killed"] == [0, 1, 2, 3]  # died at 3; 0-2 are durable
    assert rec["parts_killed"] == {"sweep.p0.json": {
        str(c): {"val": c * 10} for c in range(3)}}
    # completed cases were NOT re-run; only 3 (retried) and 4, 5 ran
    assert rec["runs"] == [0, 1, 2, 3, 3, 4, 5]
    assert [r["val"] for r in rec["out"]] == [0, 10, 20, 30, 40, 50]
    assert "__error__" in rec["recs"][1]
    assert "__error__" in rec["parts_failed"]["sweep2.p0.json"]["1"]
    assert rec["out2"][1] == {"val": 1}
    assert rec["parts"]["sweep2.p0.json"]["1"] == {"val": 1}
    assert rec["files"] == ["sweep.p0.json", "sweep2.p0.json"]
    assert _kill_and_resume(_jax_parallel().sweep_over_processes,
                            tmp_path / "jax") == rec


def test_distributed_initialize_inert_without_cluster_signals(monkeypatch):
    """With no coordinator args and no launcher env vars, initialize()
    returns False WITHOUT touching torch.distributed, so a later explicit
    call is still possible; a half-configured job raises."""
    import torch.distributed as dist

    for k in SIGNALS + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert distributed.initialize() is False
    assert distributed.initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert parallel.process_count() == 1 and parallel.process_index() == 0
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("tcp://localhost:1", device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="half-configured"):
        distributed.initialize(device="cpu")
    assert not dist.is_initialized()


def test_dummy_future_semantics():
    """Lazy compute, done() always true, exception capture vs raise."""
    from generative_physics_informed_pde_tpu_torch.parallel import (
        DummyFuture)

    calls = []
    fut = DummyFuture(False, lambda a, b: calls.append(1) or a + b,
                      (2, 3), {})
    assert fut.done() and not calls      # lazy: nothing ran yet
    assert fut.result() == 5 and calls == [1]
    assert fut.result() == 5 and calls == [1]   # cached, not re-run

    boom = DummyFuture(True, lambda: 1 // 0, (), {})
    assert isinstance(boom.exception(), ZeroDivisionError)  # captured
    with pytest.raises(ZeroDivisionError):
        boom.result()

    strict = DummyFuture(False, lambda: 1 // 0, (), {})
    with pytest.raises(ZeroDivisionError):
        strict.compute()                 # uncaught mode raises eagerly


def test_batch_pspec_unknown_axis_raises():
    """A typo'd batch axis fails loudly, not silently falling back to a
    different (or no) split."""
    mesh = _cpu_mesh(1, ("dp",))
    assert batch_pspec(mesh) == ("dp",)
    with pytest.raises(ValueError, match="not in mesh axes"):
        batch_pspec(mesh, axis="pd")
    hmesh = _cpu_mesh(1, ("dcn", "dp"), (1, 1))
    with pytest.raises(ValueError, match="not in mesh axes"):
        batch_pspec(hmesh, axis="mc")
    with pytest.raises(ValueError, match="not in mesh axes"):
        shard_data_dict({"X": torch.zeros(4)}, mesh, axis="pd")
    # the JAX package raises the same messages
    jpar = _jax_parallel()
    jpspec = jpar.mesh.batch_pspec
    assert _raised(jpspec, jpar.make_mesh(1, ("dp",)), axis="pd") \
        == _raised(batch_pspec, mesh, axis="pd")
    assert _raised(jpspec, jpar.make_mesh(1, ("dcn", "dp"), (1, 1)),
                   axis="mc") == _raised(batch_pspec, hmesh, axis="mc")


def test_durable_sweep_result_types_uniform(tmp_path):
    """With checkpointing on, freshly-computed and resumed results have
    identical (JSON-row) types: numpy arrays and tensors become lists on
    BOTH paths."""
    path = str(tmp_path / "sweep")

    def fn(c):
        return {"v": np.array([c, c + 1.0]), "t": torch.tensor([c * 2.0])}

    out1 = sweep_over_processes(fn, [0, 1, 2], checkpoint_path=path)
    assert all(isinstance(r["v"], list) and isinstance(r["t"], list)
               for r in out1), out1
    # resume with one extra case: mixed resumed + fresh results
    out2 = sweep_over_processes(fn, [0, 1, 2, 3], checkpoint_path=path)
    assert all(isinstance(r["v"], list) for r in out2), out2
    assert out2[:3] == out1
    # the JAX package's sweep: the same rows on both paths, the same file
    jpar, jpath = _jax_parallel(), tmp_path / "jax" / "sweep"
    jpath.parent.mkdir()
    assert jpar.sweep_over_processes(fn, [0, 1, 2],
                                     checkpoint_path=str(jpath)) == out1
    assert jpar.sweep_over_processes(fn, [0, 1, 2, 3],
                                     checkpoint_path=str(jpath)) == out2
    assert _parts(jpath.parent) == _parts(tmp_path)


def test_shard_data_dict_replicates_awkward_leaves_single_process():
    """On one device every leaf stays whole, 0-d leaves and leading dims
    that would not divide a larger mesh included (the two-process test
    checks the split)."""
    mesh = _cpu_mesh(1, ("dp",))
    data = {"X": torch.zeros((16, 4)), "n": torch.tensor(5.0),
            "odd": np.zeros((6, 4))}
    out = shard_data_dict(data, mesh)
    assert out["X"].shape == (16, 4)
    assert out["n"].ndim == 0 and float(out["n"]) == 5.0
    assert out["odd"].shape == (6, 4) and isinstance(out["odd"], torch.Tensor)
    # the JAX package on one device and on its mesh of all (8) devices,
    # which shards X and keeps the 0-d and the 6-row leaves whole: the
    # same values
    jpar = _jax_parallel()
    for jmesh in (jpar.make_mesh(1), jpar.make_mesh()):
        jout = jpar.shard_data_dict(_numpy(data), jmesh)
        for k in data:
            np.testing.assert_array_equal(np.asarray(jout[k]),
                                          out[k].numpy(), err_msg=k)


# ------------------------------------------------------------- two processes
def _child(rank: int, world: int, init_file: str, out_dir: str) -> None:
    """One rank of the two-process run: everything it returns goes to
    ``out_dir/rank{rank}.json``."""
    import torch.distributed as dist
    import torch_uncertainty_study as us

    torch.set_num_threads(1)
    assert parallel.initialize(f"file://{init_file}", world, rank,
                               device="cpu") is True
    assert parallel.initialize(device="cpu") is True  # idempotent
    mesh = parallel.make_mesh(device="cpu")
    assert mesh.size() == world
    rec = {"process": [parallel.process_index(), parallel.process_count()]}
    rec["devices"] = sweep_over_devices(_case_fn, CASES, mesh).tolist()
    rec["devices_item"] = sweep_over_devices(_case_fn_item, CASES,
                                             mesh).tolist()
    sh = shard_data_dict({"X": torch.arange(16.0).reshape(8, 2),
                          "n": torch.tensor(5.0), "odd": torch.zeros(3, 2)},
                         mesh)
    rec["shard"] = [sh["X"].tolist(), float(sh["n"]),
                    list(sh["odd"].shape)]
    s = parallel.local_shard_slice(8)
    rec["slice"] = [s.start, s.stop]
    rec["fetch"] = parallel.fetch(torch.arange(4.0) + 4 * rank).tolist()
    rec["processes"] = sweep_over_processes(_flaky, list(range(5)),
                                            return_exceptions=True)
    try:
        sweep_over_processes(_flaky, list(range(5)))
        rec["raised"] = None
    except RuntimeError as e:
        rec["raised"] = str(e)
    rec["durable"] = sweep_over_processes(
        lambda c: {"v": np.array([c, c + 1.0])}, list(range(5)),
        checkpoint_path=os.path.join(out_dir, "sweep"))
    phys = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(16, 16),
                                     device="cpu")
    solve, rec["solved"] = phys.solve_batched, []
    phys.solve_batched = lambda a, b: (rec["solved"].append(a.shape[0]),
                                       solve(a, b))[1]
    out = us.qoi_sweep(phys, LENGTHS, B=8, mesh=mesh, n=16, device="cpu")
    rec["qoi"] = {k: v.tolist() for k, v in out.items()}
    # 3 cases x B = 3: 9 systems do not split over two processes
    try:
        us.qoi_sweep(phys, LENGTHS[:3], B=3, mesh=mesh, n=16, device="cpu")
        rec["uneven"] = None
    except ValueError as e:
        rec["uneven"] = str(e)
    # 3 device-sweep cases do not split either: each process runs all
    odd = {k: v[:3] for k, v in CASES.items()}
    rec["devices_odd"] = sweep_over_devices(_case_fn, odd, mesh).tolist()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)
    dist.destroy_process_group()


def test_two_process_gloo_sweeps_match_one_process(tmp_path):
    import torch_uncertainty_study as us

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    for k in SIGNALS:
        env.pop(k, None)
    init = tmp_path / "init"
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--child", str(r), "2", str(init),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for pr in procs:
        try:
            o, _ = pr.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            pr.kill()
            o, _ = pr.communicate()
        outs.append(o)
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r} failed:\n{outs[r][-4000:]}"
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    assert [r["process"] for r in recs] == [[0, 2], [1, 2]]
    # the local shares: contiguous rows, awkward leaves whole
    assert [r["slice"] for r in recs] == [[0, 4], [4, 8]]
    X = np.arange(16.0).reshape(8, 2)
    for r, rec in enumerate(recs):
        assert rec["shard"] == [X[4 * r:4 * r + 4].tolist(), 5.0, [3, 2]]
        assert rec["fetch"] == list(range(8))
    # every rank returns the one-process results
    one = {"devices": sweep_over_devices(_case_fn, CASES).tolist(),
           "devices_item": sweep_over_devices(_case_fn_item, CASES).tolist(),
           "processes": sweep_over_processes(_flaky, list(range(5)),
                                             return_exceptions=True),
           "durable": sweep_over_processes(
               lambda c: {"v": np.array([c, c + 1.0])}, list(range(5)),
               checkpoint_path=str(tmp_path / "one")),
           "devices_odd": sweep_over_devices(
               _case_fn, {k: v[:3] for k, v in CASES.items()}).tolist()}
    with pytest.raises(RuntimeError) as err:
        sweep_over_processes(_flaky, list(range(5)))
    # ... which is the JAX package's
    jpar = _jax_parallel()
    assert jpar.sweep_over_processes(_flaky, list(range(5)),
                                     return_exceptions=True) \
        == one["processes"]
    assert _raised(jpar.sweep_over_processes, _flaky, list(range(5))) \
        == (RuntimeError, str(err.value))
    for rec in recs:
        for k, v in one.items():
            assert rec[k] == v, k
        assert rec["raised"] == str(err.value) and "boom" in rec["raised"]
        assert rec["uneven"] == "global batch 9 not divisible by 2 processes"
    # each rank's part file holds its round-robin cases; together the
    # one-process file
    parts = _parts(tmp_path)
    assert sorted(parts) == ["one.p0.json", "sweep.p0.json", "sweep.p1.json"]
    assert sorted(parts["sweep.p0.json"]) == ["0", "2", "4"]
    assert {**parts["sweep.p0.json"], **parts["sweep.p1.json"]} \
        == parts["one.p0.json"]
    phys = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(16, 16),
                                     device="cpu")
    local = us.qoi_sweep(phys, LENGTHS, B=8, n=16, device="cpu")
    # each rank solved its 16 of the 32 systems (and none of the uneven
    # sweep's), and both hold all moments
    assert [r["solved"] for r in recs] == [[16], [16]]
    assert recs[0]["qoi"] == recs[1]["qoi"]
    for k, v in local.items():
        got = np.asarray(recs[0]["qoi"][k])
        assert got.shape == (4,) and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, v.numpy(), rtol=1e-5, atol=1e-6)
    # informative, not degenerate: centre pressure ~ 0.5 for the 0 -> 1
    # profile
    assert np.all(local["mean"].numpy() > 0.2)
    assert np.all(local["std"].numpy() > 0.0)


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
