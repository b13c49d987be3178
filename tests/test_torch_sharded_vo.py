"""The virtual observables and the training-set analysis split over the
processes of a mesh, as the JAX package's layout splits them.

On a mesh the JAX package lays the VO rows out as ``P('dp')``: the
ensemble's ``_mean`` / ``_vars``, the propagated moments and the energy
arm's iterates are row-sharded, while the constrain arm's test-function
assembly (``Gamma``, ``alpha``) and the energy arm's ``K_diag`` sit whole
on one device and the precision hyperprior (``_prec_beta``,
``vo_variances``) is replicated; the training analysis's data and the
validation analysis's output are ``P('dp')``.  The port's sharded
trainer does the same with one process a shard.

1. Two gloo processes (this file run as a script with ``--child``; it
   imports no JAX) train ``tests/test_parallel.py``'s energy-VO recipe
   (``test_torch_sharded_training._make_trainer(energy=True)``: 8
   labeled, 8 VO, 16 unlabeled 32^2 fields, f64) and the same recipe
   with ``vo_spec_preset("constrain")``: 6 steps (refreshes at 0, 2, 4),
   a monitor point (validation, training and encoder analyses), a
   checkpoint at step 6 and 2 more steps (a refresh at 6).  Held to one
   process in this process to 1e-9 of the scale: the VO moments, the
   precision hyperprior, q_z, the parameters, the ELBOs and the analyses'
   rel-L2, R^2 and logscore; the generators bit for bit.  Each process
   holds 4 of the 8 VO rows, the rest whole.
2. Checkpoints move between layouts: the two processes' checkpoint
   restores in one process with its VO state bit-equal to theirs and
   continues as they do (1e-9); one process's checkpoint restores on the
   two with each process's rows bit-equal to the file's and continues as
   one process does; a checkpoint restored on its own layout at a
   refresh step continues bit for bit as the unbroken run.
3. ``tests/data/vo_failure_2h.npz``'s sample on two rows (f64), one per
   process, the second's conditioning failing as it did on the card:
   the failure count and the warning are global (1 of 2 on both
   processes), each process flags its own rows, and the next precision
   update, weighted over the clean rows of both, equals one process's.
4. Against the JAX package on conftest's 8 virtual devices, with the
   same draws injected from numpy in call order, in f64 to rtol 1e-10 /
   atol 1e-12 (the JAX package's own sharded test uses rtol 5e-3 / atol
   1e-5): the Monte-Carlo
   propagation and the energy update on P('dp') inputs against each of
   two processes' rows (computed here: neither has a collective); the
   constrain arm's conditioning with a failed sample and its precision
   update, and the row-split analysis (y in chunks, x), in the two
   processes.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))
from generative_physics_informed_pde_tpu_torch import fem as tfem  # noqa: E402
from generative_physics_informed_pde_tpu_torch import parallel  # noqa: E402
from generative_physics_informed_pde_tpu_torch.constraints import (  # noqa
    virtual_observables as tvo, vo_spec_preset)
from generative_physics_informed_pde_tpu_torch.inference import (  # noqa
    analysis as tanalysis, likelihoods as tlik, variational as tva)
from generative_physics_informed_pde_tpu_torch.models import (  # noqa: E402
    components as tcomp)
from generative_physics_informed_pde_tpu_torch.parallel.layout import (  # noqa
    RowSplit, share)
from test_torch_sharded_training import (  # noqa: E402
    CHILD_TIMEOUT, SIGNALS, _assert_close, _draw_pools, _make_trainer,
    _record)

RTOL = 1e-9
JAX_RTOL, JAX_ATOL = 1e-10, 1e-12  # f64, the same draws
WORLD, STEPS, MORE = 2, 6, 2
ARMS = ("energy", "constrain")
FAILURE = HERE / "data" / "vo_failure_2h.npz"
N_C = 8                             # samples of the component cases
STAND_IN = dict(num_refines=2, dec_blocks=(1,), dtype="float64")  # 16^2
S_Y, CHUNK = 4, 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the recipe
def _trainer(pools, arm, mesh=None):
    """``tests/test_parallel.py``'s ``_make_energy_vo_trainer`` on the
    port in f64, the constrain arm with ``vo_spec_preset('constrain')``."""
    data = {} if arm == "energy" else {"vo_spec": vo_spec_preset("constrain")}
    return _make_trainer(pools, 17, energy=True, mesh=mesh, data=data)


def _whole(x, mesh):
    x = x.detach()
    return (x if mesh is None else parallel.gather_batch(x, mesh)).numpy()


def _state(tr, mesh=None, last=None):
    """What a run is compared on: ``_record``'s (with ``last``, the last
    ELBOs only), the VO state and the analyses' series, whole."""
    out = _record(tr, mesh)
    if last is not None:
        out["elbo"] = out["elbo"][-last:]
    vo = tr.VO
    out["vo_vars"] = _whole(vo.vars, mesh)
    if hasattr(vo, "_prec_beta"):
        out["vo_prec_beta"] = vo._prec_beta.numpy()
        out["vo_variances"] = vo.vo_variances.numpy()
        out["vo_prec_alpha"] = np.asarray(vo._prec_alpha)
    for name, an in (("val", tr._analysis), ("train", tr._analysis_training)):
        for k in ("relerr_y", "r2_y", "logscore_y"):
            out[f"{name}_{k}"] = np.asarray(an.series[k].value)
    # copies: ``.numpy()`` of a CPU tensor shares the storage that the
    # next steps update in place
    return {k: np.array(v, copy=True) for k, v in out.items()}


def _run(tr, mesh=None):
    """STEPS steps, a monitor point -> the state; then the state after
    MORE steps (the caller saves in between)."""
    for _ in range(STEPS - 1):
        tr.step()
    tr._record(tr.step())
    return _state(tr, mesh)


def _more(tr, mesh=None):
    for _ in range(MORE):
        tr.step()
    return _state(tr, mesh, last=MORE)


def _pre(prefix, d):
    return {prefix + k: v for k, v in d.items()}


# --------------------------------------------------- the failure replay
def _replay_ensemble():
    """The captured sample on two rows in f64 (the first with a 1%
    larger prior precision), a learnable precision of unit prior rate:
    (ensemble, G, PREC)."""
    with np.load(FAILURE) as f:
        s = {k: f[k].astype(np.float64) for k in
             ("Gamma", "alpha", "G", "PREC")}
    vo = object.__new__(tvo.VirtualObservablesEnsemble)
    m = s["Gamma"].shape[1]
    vo.dtype, vo.device, vo.N, vo.m = torch.float64, torch.device("cpu"), 2, m
    vo.prior_precision_factor = 1.0
    vo._Gamma = torch.as_tensor(np.repeat(s["Gamma"], 2, 0))
    vo._alpha = torch.as_tensor(np.repeat(s["alpha"], 2, 0))
    vo._fixed_precision = False
    vo.infinite_precision_mask = torch.zeros(m, dtype=torch.bool)
    vo._prec_alpha = 0.5 * vo.N + vo.ALPHA_0
    vo._prec_beta = torch.ones(m, dtype=torch.float64)
    vo.vo_variances = vo._mean_vo_variances()
    vo._mean = vo._vars = vo._fallback_mask = None
    G = torch.as_tensor(np.repeat(s["G"], 2, 0))
    PREC = torch.as_tensor(np.repeat(s["PREC"], 2, 0))
    PREC[0] *= 1.01
    return vo, G, PREC


def _failing_on(prec_row):
    """``condition_ensemble`` with the sample whose prior precision is
    ``prec_row`` failing, as the card's f32 factorisation failed."""
    real = tvo.condition_ensemble

    def condition(Gamma, alpha, G, PREC, vo_var, eps=0.0):
        mean, vars_ = real(Gamma, alpha, G, PREC, vo_var, eps)
        hit = (PREC == prec_row).all(dim=1)[:, None]
        return (torch.where(hit, torch.nan, mean),
                torch.where(hit, torch.nan, vars_))
    return condition


class _Writer:
    def __init__(self):
        self.logged = []

    def add_scalar(self, tag, value, global_step=None):
        self.logged.append((tag, float(value), global_step))


def _replay(layout=None, rows=slice(None)):
    """Two updates of the replay ensemble (the first fails on row 1)
    -> the record."""
    vo, G, PREC = _replay_ensemble()
    vo.shard(layout)
    writer = _Writer()
    cond = tvo.condition_ensemble
    tvo.condition_ensemble = _failing_on(PREC[1])
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            vo.update(G[rows], PREC[rows], 73, writer=writer)
    finally:
        tvo.condition_ensemble = cond
    fb = vo._fallback_mask.clone()
    vo.update(G[rows], PREC[rows], 74, writer=writer)
    whole = vo.moments()
    return {"replay/mean": whole["mean"].numpy(),
            "replay/vars": whole["vars"].numpy(),
            "replay/prec_beta": vo._prec_beta.numpy(),
            "replay/prec_alpha": np.asarray(vo._prec_alpha),
            "replay/fallback": fb.numpy(),
            "replay/failures": np.asarray([v for t, v, _ in writer.logged
                                           if "failures" in t]),
            "replay/warning": np.asarray(
                [str(w.message) for w in caught][:1])}


# ------------------------------------------- component cases (the children)
def _inject_numpy(seed, put=setattr):
    """Every port sampler of the component cases draws whole arrays from
    one numpy stream in call order (``put``: how a module attribute is
    replaced; here ``monkeypatch.setattr``)."""
    rng = np.random.default_rng(seed)

    def normal(shape, like=None, generator=None):
        return torch.as_tensor(rng.standard_normal(tuple(shape)))

    for mod in (tva, tcomp, tlik, tanalysis):
        put(mod, "standard_normal", normal)
    put(tvo, "sketch_normals", lambda shape, g, dtype, device: normal(
        shape).to(dtype))
    put(tvo, "rbf_uniforms", lambda shape, g, dtype, device: torch.as_tensor(
        rng.random(tuple(shape)), dtype=dtype))


def _constrain_samplers(tphys):
    fom = tphys["fom"]
    coords = fom.grid.node_coords[fom.profile.free_dofs]
    return tvo.ConcatenatedSamplers([
        tvo.CoarseGrainedResidualSampler(W=tphys["W"]),
        tvo.FluxConstrainSampler(
            operator=tvo.FluxConstraintOperator(
                coarse=tphys["rom"].grid, fine=fom.grid), physics=fom),
        tvo.GaussianSketchingSampler(5),
        tvo.RadialBasisFunctionSampler(l=0.3, N_aux=4, coords=coords)])


def _component_constrain(inp, layout):
    """The constrain arm on the 9^2 geometry's N_C samples: a first update
    with sample 5's Cholesky failing (negative prior precision), a
    resample, a second update that learns the precision."""
    _inject_numpy(int(inp["seed"]))
    tphys = tfem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    q = tvo.QuerryPointEnsemble(tphys["fom"], torch.as_tensor(inp["logx"]),
                                torch.as_tensor(inp["bcv"]))
    vo = tvo.VirtualObservablesEnsemble(q, _constrain_samplers(tphys),
                                        dtype=torch.float64)
    vo.shard(layout)
    rows = vo.split.take
    G, P0, P1 = (torch.as_tensor(inp[k]) for k in ("G", "PREC0", "PREC1"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vo.update(rows(G), rows(P0), 0)
    fb = vo._fallback_mask.clone()
    vo.resample(None)
    vo.update(rows(G), rows(P1), 1)
    whole = vo.moments()
    return {"constrain/mean": whole["mean"].numpy(),
            "constrain/vars": whole["vars"].numpy(),
            "constrain/vo_variances": vo.vo_variances.numpy(),
            "constrain/prec_alpha": np.asarray(vo._prec_alpha),
            "constrain/fallback": fb.numpy(),
            "constrain/rows": np.asarray(vo._mean.shape[0]),
            "constrain/Gamma_rows": np.asarray(vo.Gamma.shape[0])}


def _stand_in_model(state_path):
    from generative_physics_informed_pde_tpu_torch.factories import highres32

    _, model, _, _, _ = highres32(**STAND_IN).setup(device="cpu")
    model.init_params({"supervised": {"X": np.zeros((N_C, 1))}})
    model.load_state_dict(torch.load(state_path, weights_only=True))
    return model.eval()


def _component_analysis(inp, layout, state_path):
    """The row-split analysis of the 16^2 stand-in's N_C fields: y in
    chunks of CHUNK (the one-shot path is the trainer's, held to one
    process above), x in one shot."""
    split = layout.rows(N_C)
    model = _stand_in_model(state_path)
    data = {k: split.take(torch.as_tensor(inp[k]))
            for k in ("X", "Y", "F_ROM_BC")}
    q = {k: split.take(torch.as_tensor(inp["q_" + k]))
         for k in ("mean", "logsigma")}
    a = tanalysis.Analysis(model, data, split=split)
    out = {}
    budget = tanalysis._EVAL_ELEMENT_BUDGET
    _inject_numpy(int(inp["seed"]))
    tanalysis._EVAL_ELEMENT_BUDGET = CHUNK * N_C * int(inp["Y"].shape[-1])
    try:
        y_mean, y_std = a.eval_all_y(q, None, S_Y, iteration=0,
                                     return_mean_std=True)
    finally:
        tanalysis._EVAL_ELEMENT_BUDGET = budget
    out["analysis/y_mean"] = layout.gather(y_mean).numpy()
    out["analysis/y_std"] = layout.gather(y_std).numpy()
    for k in ("relerr_y", "r2_y", "logscore_y"):
        out[f"analysis/{k}"] = np.asarray(a.series[k].final())
    out["analysis/plan"] = np.asarray(a.mc_chunks["y", S_Y])
    _inject_numpy(int(inp["seed"]))
    for k, v in a.eval_all_x(q, None, S_Y).items():
        out[f"analysis/x/{k}"] = np.asarray(v)
    return out


# ------------------------------------------------------------ the children
def _child(rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert parallel.initialize(f"file://{init}", world, rank, device="cpu")
    out = Path(out)
    with np.load(out / "pools.npz") as f:
        pools = (f["X"], f["Xu"])
    mesh = parallel.make_mesh(device="cpu")
    rec = {}
    for arm in ARMS:
        tr = _trainer(pools, arm, mesh)
        vo = tr.VO
        rec.update(_pre(f"{arm}:run/", _run(tr, mesh)))
        rec[f"{arm}:local_rows"] = np.asarray(
            [vo._mean.shape[0], vo.vars.shape[0]])
        rec[f"{arm}:whole_rows"] = np.asarray(
            (vo._K_diag if arm == "energy" else vo.Gamma).shape[0])
        ckpt = str(out / f"{arm}.sharded.pt")
        tr.save_checkpoint(ckpt)
        rec.update(_pre(f"{arm}:more/", _more(tr, mesh)))
        tr.restore_checkpoint(ckpt)  # its own layout, at a refresh step
        rec.update(_pre(f"{arm}:resumed/", _more(tr, mesh)))
        one = str(out / f"{arm}.one.pt")
        if rank == 0:  # one process's checkpoint, written unsharded
            ref = _trainer(pools, arm)
            _run(ref)
            ref.save_checkpoint(one)
            del ref
        dist.barrier()
        tr.restore_checkpoint(one)
        rec[f"{arm}:restored_mean"] = tr.VO.mean.numpy().copy()
        rec.update(_pre(f"{arm}:from_one/", _more(tr, mesh)))
        del tr
    layout = parallel.layout.TrainLayout(mesh)
    rec.update(_replay(layout, slice(rank, rank + 1)))
    with np.load(out / "inputs.npz") as f:
        inp = {k: f[k] for k in f.files}
    rec.update(_component_constrain(inp, layout))
    rec.update(_component_analysis(inp, layout, out / "stand_in.pt"))
    np.savez(out / f"rank{rank}.npz", **rec)
    dist.destroy_process_group()


def _start_children(tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE.parent) + os.pathsep + env.get(
        "PYTHONPATH", "")
    for k in SIGNALS:
        env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, __file__, "--child", str(r), str(WORLD),
         str(tmp / "init"), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def _wait(procs):
    outs = []
    for pr in procs:
        try:
            o, _ = pr.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = pr.communicate()
        outs.append(o)
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r} failed:\n{outs[r][-4000:]}"


# ------------------------------------------------ the JAX side's inputs
def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from generative_physics_informed_pde_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8)

    def dp(x):
        return jax.device_put(jnp.asarray(x),
                              NamedSharding(mesh, PartitionSpec("dp")))
    return jax, jnp, dp


def _component_inputs(tmp):
    """The component cases' inputs, from numpy: the 9^2 geometry's N_C
    fields, their Dirichlet values and predictive moments; the 16^2
    stand-in's JAX state, carried into the port (written for the
    children), its fields, labels, forces and posterior."""
    jax, jnp, _ = _jax()
    from generative_physics_informed_pde_tpu import fem as jfem
    from generative_physics_informed_pde_tpu.factories import model as jmf
    from generative_physics_informed_pde_tpu_torch.convert import (
        load_flax_variables)
    from generative_physics_informed_pde_tpu_torch.factories import (
        highres32)

    rng = np.random.default_rng(0)
    jphys = jfem.make_fom_rom_pair("NDP", 2, 2, 2)
    fom = jphys["fom"]
    bce = jfem.BoundaryConditionEnsemble.from_factory("NDP", N_C, rng)
    bce.register_function_space("fom", fom.grid)
    bce.register_function_space("rom", jphys["rom"].grid)
    logx = rng.normal(0.2, 0.4, (N_C, fom.grid.n_cells))
    bcv = np.asarray(bce.constrained_values("fom"))
    G = rng.normal(size=(N_C, fom.dim_out))
    PREC1 = rng.uniform(0.5, 2.0, G.shape)
    PREC0 = PREC1.copy()
    PREC0[5] = -1.0  # sample 5's Schur system is negative definite
    inp = dict(seed=np.asarray(23), logx=logx, bcv=bcv, G=G, PREC0=PREC0,
               PREC1=PREC1)

    jphys16, jm, _, _, _ = jmf.highres32(**STAND_IN).setup()
    X = rng.normal(0.4, 0.8, (N_C, 16, 16))
    params, bs = jm.init_params(jax.random.PRNGKey(0),
                                {"supervised": {"X": jnp.asarray(X)},
                                 "vo": {"X": jnp.asarray(X)}}, (16, 16))
    params, bs = (jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t) for t in (params, bs))
    for q in params["q_X"].values():
        q["mean"] = rng.normal(0.0, 0.3, q["mean"].shape)
        q["logsigma"] = -1.0 + 0.1 * rng.normal(size=q["logsigma"].shape)
    _, model, _, _, _ = highres32(**STAND_IN).setup(device="cpu")
    model.init_params({"supervised": {"X": np.zeros((N_C, 1))},
                       "vo": {"X": np.zeros((N_C, 1))}})
    load_flax_variables(model, params, bs)
    sup = {k: v for k, v in model.state_dict().items()
           if ".vo." not in k}
    torch.save(sup, tmp / "stand_in.pt")
    dz = params["q_z"]["supervised"]["mean"].shape[-1]
    inp.update(X=X, Y=rng.normal(0.0, 0.3, (N_C, jm.g.dim_out)),
               F_ROM_BC=rng.normal(0.0, 1.0,
                                   (N_C, jphys16["rom"].grid.n_nodes)),
               q_mean=0.3 * rng.normal(size=(N_C, dz)),
               q_logsigma=-1.0 + 0.1 * rng.normal(size=(N_C, dz)))
    np.savez(tmp / "inputs.npz", **inp)
    return inp, (jphys, jm, params, bs, model)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The pools and the component inputs, then the two children, started
    here so that they train while this process runs the JAX package and
    the one-process runs; -> (their records, the directory, the inputs,
    the JAX side's state)."""
    tmp = tmp_path_factory.mktemp("sharded_vo")
    X, Xu = _draw_pools()
    np.savez(tmp / "pools.npz", X=X, Xu=Xu)
    inp, setting = _component_inputs(tmp)
    procs = _start_children(tmp)
    try:
        yield procs, tmp, (X, Xu), inp, setting
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()


@pytest.fixture(scope="module")
def records(children):
    procs, tmp = children[:2]
    _wait(procs)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _close(got, ref, what):
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max() / scale
    assert np.isfinite(got).all() and err <= RTOL, (what, err)


def _part(rec, prefix):
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def _held(recs, ref, prefix, what):
    for r, rec in enumerate(recs):
        _assert_close(_part(rec, prefix), ref, f"{what} rank {r}")


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("arm", ARMS)
def test_sharded_vo_training_equals_one_process(arm, children, records):
    """6 steps, a monitor point, a checkpoint and 2 more steps on two
    processes against one; the checkpoints move between the layouts."""
    tmp, pools = children[1], children[2]
    tr = _trainer(pools, arm)
    ref = _run(tr)
    assert len(ref["val_r2_y"]) == len(ref["train_r2_y"]) == 1
    assert np.isfinite(ref["vo_mean"]).all()
    if arm == "energy":
        assert ref["vo_temperature"] < 1.0
    else:
        assert ref["vo_prec_alpha"] == 0.5 * 8 + 1e-6  # learnt, all clean
    _held(records, ref, f"{arm}:run/", arm)
    for rec in records:  # 4 of the 8 VO rows a process, the rest whole
        assert rec[f"{arm}:local_rows"].tolist() == [4, 4]
        assert int(rec[f"{arm}:whole_rows"]) == 8
    ref_more = _more(tr)
    _held(records, ref_more, f"{arm}:more/", f"{arm} continued")
    _held(records, ref_more, f"{arm}:from_one/", f"{arm} from one process")
    one = torch.load(tmp / f"{arm}.one.pt", weights_only=True)["vo"]
    for r, rec in enumerate(records):
        # restored on the layout that wrote it, at a refresh step: the
        # unbroken run, bit for bit
        more = _part(rec, f"{arm}:more/")
        for k, v in _part(rec, f"{arm}:resumed/").items():
            np.testing.assert_array_equal(v, more[k], err_msg=k)
        # one process's file, cut to this process's rows, bit for bit
        np.testing.assert_array_equal(rec[f"{arm}:restored_mean"],
                                      one["mean"].numpy()[4 * r:4 * (r + 1)])
    # the two processes' checkpoint in one process: the VO state bit for
    # bit, then the two processes' continuation
    sharded = torch.load(tmp / f"{arm}.sharded.pt", weights_only=True)
    np.testing.assert_array_equal(sharded["vo"]["mean"].numpy(),
                                  records[0][f"{arm}:run/vo_mean"])
    tr.restore_checkpoint(str(tmp / f"{arm}.sharded.pt"))
    for k, v in sharded["vo"].items():
        if torch.is_tensor(v):
            assert torch.equal(tr.VO.moments()[k], v), k
    _assert_close(_more(tr), _part(records[0], f"{arm}:more/"),
                  f"{arm}: the two processes' checkpoint in one")


def test_a_failed_conditioning_is_counted_over_the_processes(records):
    """The card's failure on one of two rows: 1 of 2 on both processes,
    the failing row flagged on its own process only, and the precision
    update weighted over the clean row equal to one process's."""
    ref = _replay()
    assert ref["replay/failures"].tolist() == [1.0]
    assert ref["replay/fallback"].tolist() == [False, True]
    assert ref["replay/prec_alpha"] == 0.5 * 1 + 1e-6
    assert "1/2 samples at iteration 73" in str(ref["replay/warning"][0])
    for r, rec in enumerate(records):
        assert rec["replay/failures"].tolist() == [1.0]
        assert rec["replay/fallback"].tolist() == [r == 1]
        assert str(rec["replay/warning"][0]) == str(ref["replay/warning"][0])
        assert rec["replay/prec_alpha"] == ref["replay/prec_alpha"]
        for k in ("mean", "vars", "prec_beta"):
            _close(rec[f"replay/{k}"], ref[f"replay/{k}"], f"replay {k}")


class _Rank:
    """One of two processes' view of a 2-shard layout, without a group:
    for computations that sum nothing over the processes."""

    k_rows, lead = 2, True

    def __init__(self, r):
        self.r = r

    def rows(self, n):
        return RowSplit(n, (share(n, 2, self.r),), None)

    def block(self, n_local):
        return self.rows(n_local * 2)


def _jax_inject(monkeypatch, seed):
    """The JAX package's samplers on the same numpy stream as
    ``_inject_numpy``'s."""
    jax, jnp, _ = _jax()
    from generative_physics_informed_pde_tpu.constraints import (
        virtual_observables as jvo)
    from generative_physics_informed_pde_tpu.inference import (
        analysis as janalysis, variational as jva)
    from generative_physics_informed_pde_tpu.models import (
        components as jcomp, generative as jgen)
    from test_torch_constraints import _Jax

    rng = np.random.default_rng(seed)

    def jn(shape):
        return jnp.asarray(rng.standard_normal(tuple(shape)))

    def sample_all(params, key, n):
        m, ls = params["mean"][:, None], params["logsigma"][:, None]
        return m + jnp.exp(ls) * jn((m.shape[0], n, m.shape[-1]))

    def gp(gp_out, key):
        if not isinstance(gp_out, tuple):
            return gp_out
        mean, logsigmas = gp_out
        return mean + jnp.exp(logsigmas) * jn(logsigmas.shape)

    def propagate(self, params, effprops, F, key):
        mean, logsigmas = self(params, effprops, F)
        return mean + jnp.exp(logsigmas) * jn(mean.shape)

    for mod, name, fn in (
            (jva, "sample_all_components", sample_all),
            (janalysis, "propagate_gp_samples", gp),
            (jgen, "propagate_gp_samples", gp),
            (jcomp.ReducedOrderModelOperator, "propagate_samples",
             propagate), (janalysis, "jax", _Jax(rng)),
            (jvo, "jax", _Jax(rng))):
        monkeypatch.setattr(mod, name, fn)


def _sharding_is_dp(x):
    return tuple(x.sharding.spec) == ("dp",) and \
        len(x.sharding.device_set) == 8


def _rel(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=JAX_RTOL,
                               atol=JAX_ATOL)


def test_propagation_and_energy_update_on_rows_match_jax(children,
                                                          monkeypatch):
    """Each process's rows of the propagated moments (the draws made
    whole and cut) and of two energy updates, against the JAX package's
    P('dp') results on 8 devices."""
    jax, jnp, dp = _jax()
    from generative_physics_informed_pde_tpu.constraints import (
        virtual_observables as jvo)

    inp = children[3]
    jphys, jm, params, bs, model = children[4]
    seed = int(inp["seed"])
    S = 4
    # propagation (independent_X: the q_X['vo'] draws and the ROM's)
    _jax_inject(monkeypatch, seed)
    jdata = {"X": dp(inp["X"]), "F_ROM_BC": dp(inp["F_ROM_BC"])}
    jparams = dict(params, q_X={**params["q_X"], "vo": {
        k: dp(v) for k, v in params["q_X"]["vo"].items()}})
    jm_, js_ = jm.propagate_vo_moments(jparams, jdata,
                                       jax.random.PRNGKey(0), S)
    assert _sharding_is_dp(jm_) and _sharding_is_dp(js_)
    got = []
    for r in range(2):
        model.layout = _Rank(r)
        rows = model.layout.rows(N_C).take
        _inject_numpy(seed, monkeypatch.setattr)
        with torch.no_grad():
            got.append(model.propagate_vo_moments(
                {"X": rows(torch.as_tensor(inp["X"])),
                 "F_ROM_BC": rows(torch.as_tensor(inp["F_ROM_BC"]))},
                None, S, q={k: rows(v) for k, v in
                            model.q_X["vo"].items()}))
        assert got[-1][0].shape == (N_C // 2, model.dim_y)
    model.layout = None
    _rel(torch.cat([g[0] for g in got]), jm_)
    _rel(torch.cat([g[1] for g in got]), js_)

    # the energy update: 3 subspace iterations, twice (the mean carries)
    fom = jphys["fom"]
    tphys = tfem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    coords = fom.grid.node_coords[fom.profile.free_dofs]
    jq = jvo.QuerryPointEnsemble(physics=fom, X_DG=jnp.asarray(inp["logx"]),
                                 bc_values=jnp.asarray(inp["bcv"]))
    jv = jvo.EnergyVirtualObservablesEnsemble(
        jq, 3, jvo.RadialBasisFunctionSampler(l=0.3, N_aux=4,
                                              coords=coords),
        dtype=jnp.float64)
    jv.set_temperature(0.3)
    jv._mean = dp(jv._mean)
    _jax_inject(monkeypatch, seed)
    want = []
    for it in range(2):
        with jax.disable_jit():
            jv.update(dp(inp["G"]), dp(inp["PREC1"]), it)
        assert _sharding_is_dp(jv.mean) and _sharding_is_dp(jv.vars)
        want.append((np.asarray(jv.mean), np.asarray(jv.vars)))
    for r in range(2):
        tq = tvo.QuerryPointEnsemble(tphys["fom"],
                                     torch.as_tensor(inp["logx"]),
                                     torch.as_tensor(inp["bcv"]))
        tv = tvo.EnergyVirtualObservablesEnsemble(
            tq, 3, tvo.RadialBasisFunctionSampler(l=0.3, N_aux=4,
                                                  coords=coords),
            dtype=torch.float64)
        tv.set_temperature(0.3)
        tv.shard(_Rank(r))
        rows = tv.split.take
        _inject_numpy(seed, monkeypatch.setattr)
        for it in range(2):
            tv.update(rows(torch.as_tensor(inp["G"])),
                      rows(torch.as_tensor(inp["PREC1"])), it)
            assert tv.mean.shape[0] == tv.vars.shape[0] == N_C // 2
            assert tv._K_diag.shape[0] == N_C  # whole, as the JAX one
            _rel(tv.mean, want[it][0][rows(torch.arange(N_C))])
            _rel(tv.vars, want[it][1][rows(torch.arange(N_C))])


def test_constrain_update_and_analysis_on_processes_match_jax(
        children, records, monkeypatch):
    """The two processes' constrain arm (a failed sample, then a learnt
    precision) and row-split analysis against the JAX package's on
    P('dp') inputs on 8 devices."""
    jax, jnp, dp = _jax()
    from generative_physics_informed_pde_tpu.constraints import (
        virtual_observables as jvo)
    from generative_physics_informed_pde_tpu.inference import (
        analysis as janalysis)
    from test_torch_constraints import _samplers

    inp = children[3]
    jphys, jm, params, bs, _ = children[4]
    seed = int(inp["seed"])
    _jax_inject(monkeypatch, seed)
    tphys = tfem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    jq = jvo.QuerryPointEnsemble(physics=jphys["fom"],
                                 X_DG=jnp.asarray(inp["logx"]),
                                 bc_values=jnp.asarray(inp["bcv"]))
    js, _ = _samplers("concatenated", jphys, tphys)
    jv = jvo.VirtualObservablesEnsemble(jq, js, dtype=jnp.float64)
    jv._sample_jit = lambda key: js.sample(jq, key)
    with pytest.warns(UserWarning, match="1/8 samples"):
        jv.update(dp(inp["G"]), dp(inp["PREC0"]), 0)
    fb = np.asarray(jv._fallback_mask)
    jv.resample(jax.random.PRNGKey(0))
    jv.update(dp(inp["G"]), dp(inp["PREC1"]), 1)
    assert _sharding_is_dp(jv.mean) and _sharding_is_dp(jv.vars)
    assert fb.tolist() == [i == 5 for i in range(N_C)]
    for r, rec in enumerate(records):
        assert int(rec["constrain/rows"]) == N_C // 2
        assert int(rec["constrain/Gamma_rows"]) == N_C
        assert rec["constrain/fallback"].tolist() == fb.tolist()[
            4 * r:4 * (r + 1)]
        assert float(rec["constrain/prec_alpha"]) == jv._prec_alpha
        for k in ("mean", "vars", "vo_variances"):
            _rel(rec[f"constrain/{k}"], getattr(jv, k))

    jdata = {k: dp(inp[k]) for k in ("X", "Y", "F_ROM_BC")}
    jqz = {k: dp(inp["q_" + k]) for k in ("mean", "logsigma")}
    ja = janalysis.Analysis(model=jm, data=jdata)
    monkeypatch.setattr(janalysis, "_EVAL_ELEMENT_BUDGET",
                        CHUNK * N_C * inp["Y"].shape[-1])
    _jax_inject(monkeypatch, seed)
    with jax.disable_jit():  # lax.map's chunks draw anew, as the port's
        want = ja.eval_all_y_fn(S_Y)(params, jqz, jax.random.PRNGKey(0),
                                     jdata["Y"], jdata["F_ROM_BC"])
    assert _sharding_is_dp(want["y_mean"])
    plan = janalysis._mc_chunk(S_Y, N_C * inp["Y"].shape[-1])
    assert plan == (CHUNK, 2)
    for rec in records:
        assert tuple(rec["analysis/plan"]) == plan
        for k in ("y_mean", "y_std", "relerr_y", "r2_y", "logscore_y"):
            _rel(rec[f"analysis/{k}"], want[k])
    monkeypatch.setattr(janalysis, "_EVAL_ELEMENT_BUDGET",
                        tanalysis._EVAL_ELEMENT_BUDGET)
    _jax_inject(monkeypatch, seed)
    with jax.disable_jit():
        want = ja.eval_all_x_fn(S_Y)(params, bs, jqz, jax.random.PRNGKey(0),
                                     jdata["X"])
    for rec in records:
        for k in ("relerr_x", "logscore_x"):
            _rel(rec[f"analysis/x/{k}"], want[k])


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
