"""SVI steps back to back (BASELINE config 3's training), one process.

Set-up draws the labelled pool (``N_s + N_val`` fields) and the unlabeled
pool (``N_u``) from ``--seed``, builds the trainer through the runner's
path (``CreateTrainerFromPermutation``: the port labels the pool), loads
the benchmark's seeded weights into it, and drives that same trainer
through its first ``checked_steps`` steps with ``Trainer.step()``, the
window's own call, recording the step's draws from the trainer's
generator.  The window then calls ``Trainer.step()`` back to back and ends
in a synchronize.  After it the plain reference (``reference/vae.py``),
given the same fields, weights and draws, works out the labels and the
first steps again: each step's labeled and unlabeled ELBO terms, the first
gradient as Adam received it (from its first moment after one step) and
the change of the weights after the checked steps, leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from generative_physics_informed_pde_tpu_torch import parallel
from generative_physics_informed_pde_tpu_torch.parallel import distributed
from portbench import fields
from portbench.drivers import label as label_driver
from portbench.reference import fem as ref
from portbench.reference import vae

DRAWS = ("randn", "randperm", "rand", "randint")


class DrawRecorder(TorchFunctionMode):
    """Records the output of every random draw made from ``generator``."""

    def __init__(self, generator):
        super().__init__()
        self.generator = generator
        self.draws = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "__name__", "") in DRAWS \
                and kwargs.get("generator") is self.generator:
            self.draws.append(out.detach().clone())
        return out


def trainer_params(ctx):
    from generative_physics_informed_pde_tpu_torch.training import (
        TrainerParameters)

    m, d, t = (ctx.config[k] for k in ("model", "data", "trainer"))
    p = TrainerParameters()
    p.identifier = m["preset"]
    p.margs = {k: m[k] for k in ("nx_rom", "ny_rom", "num_refines")}
    p.trainer.update(
        lr_init=t["lr_init"], N_monitor_interval=t["N_monitor_interval"],
        N_monte_carlo_elbo=t["N_monte_carlo_elbo"],
        N_monte_carlo_analysis=t["N_monte_carlo_analysis"],
        N_PE_interval=t["N_PE_interval"], N_PE_updates=t["N_PE_updates"])
    p.scheduler = {"milestones": t["milestones"], "factor": t["factor"]}
    p.data.update(N_u=d["N_u"], N_s=d["N_s"], N_u_max=d["N_u"],
                  N_s_max=d["N_s"], N_vo_max=0, N_vo=0, N_val=d["N_val"],
                  armortized_bs=d["armortized_bs"], vo_spec={})
    p.seed = ctx.seed % 2 ** 31
    return p


def set_precision(m: dict, tf32: bool | None = None):
    """TF32 for float32 matmuls and convolutions as the configuration
    states it (or as ``tf32`` says)."""
    on = m["allow_tf32"] if tf32 is None else tf32
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def run(ctx):
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainerFromPermutation)

    m, d, tr = ctx.config["model"], ctx.config["data"], ctx.traffic
    set_precision(m)
    if ctx.world > 1:
        parallel.initialize(device=ctx.device)
    if ctx.on_card:
        from generative_physics_informed_pde_tpu_torch.ops import _build

        _build.build_all(["stencil"])
    X_lab = label_driver.draw_pool(ctx, d["N_s"] + d["N_val"], 0)
    X_unl = label_driver.draw_pool(ctx, d["N_u"], 1)
    dl, dlu = DataLoader(X_lab), DataLoader(X_unl)
    dlu.lock_physics_assembly()
    p = trainer_params(ctx)
    trainer = CreateTrainerFromPermutation(
        p, permutation=np.arange(dl.N), permutation_u=np.arange(dlu.N),
        dl=dl, dlu=dlu, device=ctx.device)
    if ctx.world > 1:  # the ("dp",) mesh of all ranks, one card each
        trainer.setup(scheduler_spec=p.scheduler,
                      mesh=parallel.make_mesh(device=ctx.device))

    spec = vae.param_spec(m, d["N_s"])
    W0 = vae.make_weights(spec, fields.generator(ctx.seed, 999_983,
                                                 ctx.device),
                          scale=m.get("init_scale"))
    params = dict(trainer.model.named_parameters())
    # on a mesh the per-datapoint posteriors hold this rank's rows
    take = {k: rows_of(trainer, v, W0[k]) for k, v in params.items()
            if k in W0}
    if set(params) != set(W0) or any(
            tuple(take[k](W0[k]).shape) != tuple(v.shape)
            for k, v in params.items()):
        raise RuntimeError("the program's parameters differ from the "
                           "configuration's")
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(take[k](W0[k]))

    steps, grad1 = [], None
    for s in range(tr["checked_steps"]):
        with DrawRecorder(trainer.generator) as rec:
            logs = trainer.step()
        steps.append({"elbo": logs["elbo"].item(),
                      "supervised": logs["supervised_elbo"].item(),
                      "unsupervised": logs["ARM_unsupervised_elbo"].item(),
                      "draws": rec.draws})
        if s == 0:
            b1 = trainer.optimizer.param_groups[0]["betas"][0]
            # an optimizer that kept no moment received no gradient
            grad1 = {k: trainer.optimizer.state[v].get(
                "exp_avg", torch.zeros_like(v)).detach() / (1 - b1)
                for k, v in params.items()}
    W_end = {k: v.detach().clone() for k, v in params.items()}

    ctx.start_window()
    n0 = len(trainer.elbo_history)
    t_start = time.perf_counter()
    n = 0
    every = tr.get("agree_every", 1)
    while True:
        trainer.step()
        n += 1
        if ctx.world == 1:
            if time.perf_counter() - t_start >= ctx.seconds:
                break
        elif n % every == 0 and agree(ctx, time.perf_counter() - t_start
                                      >= ctx.seconds):
            break  # every rank stops after the same step
    ctx.sync()
    window = time.perf_counter() - t_start
    peak = ctx.window_peak()
    elbos = torch.stack(trainer.elbo_history[n0:]).float().cpu()
    ctx.attempted, ctx.failed = n, int((~torch.isfinite(elbos)).sum())
    ctx.e2e = {"train_steps_per_s": n / window}
    ctx.counters = {"steps": n, "window_s": window, "window_peak_bytes": peak,
                    "cards": 1}
    if ctx.trace:
        n_tr = tr["traced_iterations"]

        def traced():
            for _ in range(n_tr):
                trainer.step()

        if ctx.rank == 0:
            ctx.profile(traced, n_tr)
        else:  # the other ranks take part in the traced steps' exchanges
            traced()
    if ctx.world > 1:
        ctx.memory_peak_bytes = int(agree(ctx, ctx.memory_peak_bytes, "max"))
        ctx.counters["window_peak_bytes"] = int(agree(ctx, peak, "max"))
        ctx.counters["cards"] = ctx.world
        distributed.barrier()
        torch.distributed.destroy_process_group()
        if ctx.rank != 0:
            return
    Y_prog = dl.Y
    del trainer, dl, dlu, params, logs
    if ctx.on_card:
        torch.cuda.empty_cache()
    check(ctx, X_lab, X_unl, Y_prog, W0, steps, grad1, W_end, take)


def rows_of(trainer, param, whole):
    """The function that cuts a whole leaf to what ``param`` holds of it:
    this rank's rows of a per-datapoint posterior on a mesh, else all."""
    if trainer.model.layout is None or param.shape == whole.shape:
        return lambda x: x
    return trainer.model.layout.block(param.shape[0]).take


def agree(ctx, value, how="any"):
    """Every rank's ``value`` combined over the ranks (``any`` of a flag,
    or the ``max``), one small all-reduce."""
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=ctx.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item()) if how == "any" else t.item()


def reference_run(ctx, X_lab, X_unl, steps, W0, tf32=False, fault=None):
    """The reference's labels and checked steps: (labels (N, n_free)
    float64, (per-step ELBO terms, first gradient, final weights, the
    leaves the unlabeled term does not reach), FLOPs of a step by dtype).
    ``fault``: plant one in the reference ("state unchanged": no Adam
    step; "half the batch": the unlabeled term over the first half of
    its minibatch, doubled)."""
    m, d = ctx.config["model"], ctx.config["data"]
    Yr, theta = vae.labels(X_lab, ctx.device, tol=ctx.traffic["reference"][
        "tol"])
    n_s, S, bs = d["N_s"], ctx.config["trainer"]["N_monte_carlo_elbo"], \
        d["armortized_bs"]
    f32 = torch.float32
    F = torch.as_tensor(ref.rom_force(theta, m["nx_rom"]), dtype=f32,
                        device=ctx.device)
    Xl = torch.as_tensor(X_lab, dtype=f32, device=ctx.device)
    Xu_all = torch.as_tensor(X_unl, dtype=f32, device=ctx.device)
    batches = []
    zd, c = m["dim_latent"], 2 * m["nx_rom"] * m["ny_rom"]
    for st in steps:
        perm, eps_u, eps_z, eps_X = st["draws"][:4]
        batches.append({"data": {"X": Xl[:n_s], "Y": Yr[:n_s].to(f32),
                                 "F": F[:n_s], "Xu": Xu_all[perm[:bs]]},
                        "draws": {"eps_u": eps_u, "eps_z": eps_z,
                                  "eps_X": eps_X}})
    if fault == "half the batch":
        for b in batches:
            h = b["data"]["Xu"].shape[0] // 2
            b["data"].update(Xu=b["data"]["Xu"][:h], unsup_weight=2.0)
            b["draws"]["eps_u"] = b["draws"]["eps_u"][:h]
    lr = 0.0 if fault == "state unchanged" \
        else ctx.config["trainer"]["lr_init"]
    coarse = vae.Coarse(m, ctx.device)
    udt = getattr(torch, m["unsup_compute_dtype"])
    set_precision(m, tf32)
    try:
        own = vae.labeled_only_leaves(W0, m, coarse, batches[0], udt)
        with FlopsByDtype() as counter:
            out = vae.sgd_trace(W0, m, coarse, batches, udt, lr,
                                len(batches)) + (own,)
    finally:
        set_precision(m)
    return Yr, out, {k: v / len(batches) for k, v in counter.flops.items()}


def compare(prog: dict, ref_out) -> dict:
    """Every number the check can compare (the traffic's ``limits`` name
    those it does): the relative errors of the labeled and the unlabeled
    ELBO term at the first step and at the worst of the checked steps; the
    gap between the program's and the reference's norm of the first
    gradient, and of the change of the weights over the checked steps,
    each against the reference's norm of that leaf or of the median leaf,
    whichever is larger, at the worst leaf and at the median one."""
    elbos, g_ref, W_ref, labeled_only = ref_out
    err = {t: [abs(p[t] - r[t]) / abs(r[t])
               for p, r in zip(prog["steps"], elbos)]
           for t in ("supervised", "unsupervised")}
    gnorm = {k: g.norm().item() for k, g in g_ref.items()}
    med = float(np.median(list(gnorm.values())))
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adam: left out of both leaf comparisons
    live = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    grad = [abs(prog["grad1"][k].norm().item() - gnorm[k]) / max(gnorm[k], med)
            for k in live]
    W0 = prog["W0"]
    dref = {k: (W_ref[k] - W0[k]).norm().item() for k in live}
    dmed = float(np.median(list(dref.values())))
    change = [abs((prog["W_end"][k] - W0[k]).norm().item() - dref[k])
              / max(dref[k], dmed, 1e-30) for k in live]
    own = [i for i, k in enumerate(live) if k in labeled_only]
    return {"grad_norm_gap_labeled_leaves": max(grad[i] for i in own),
            "change_norm_gap_labeled_leaves": max(change[i] for i in own),"sup_elbo_step1_rel_err": err["supervised"][0],
            "unsup_elbo_step1_rel_err": err["unsupervised"][0],
            "sup_elbo_rel_err": max(err["supervised"]),
            "unsup_elbo_rel_err": max(err["unsupervised"]),
            "grad_norm_gap": max(grad),
            "grad_norm_gap_median_leaf": float(np.median(grad)),
            "change_norm_gap": max(change),
            "change_norm_gap_median_leaf": float(np.median(change))}


def draw_shapes_differ(ctx, steps) -> int:
    """Steps whose first four draws are not the configuration's: the
    minibatch permutation, the amortized term's normals and the labeled
    term's latent and coarse-property normals."""
    m, d = ctx.config["model"], ctx.config["data"]
    S = ctx.config["trainer"]["N_monte_carlo_elbo"]
    n_s, bs, zd = d["N_s"], d["armortized_bs"], m["dim_latent"]
    want = [(d["N_u"],), (bs, zd), (n_s, S, zd),
            (n_s, S, 2 * m["nx_rom"] * m["ny_rom"])]
    return sum([tuple(t.shape) for t in st["draws"][:4]] != want
               for st in steps)


def check(ctx, X_lab, X_unl, Y_prog, W0, steps, grad1, W_end, take=None):
    tr = ctx.traffic
    bad = draw_shapes_differ(ctx, steps)
    ctx.check("draw_shape_mismatch", bad, tr["limits"]["draw_shape_mismatch"])
    if bad:  # the program departed from the configuration's batch
        return
    # the draws' start: the first step's draws are a fresh generator's
    gen = torch.Generator(device=ctx.device).manual_seed(
        ctx.seed % 2 ** 31)
    first = steps[0]["draws"][:4]
    replay = [torch.randperm(first[0].shape[0], generator=gen,
                             device=ctx.device)] + [
        torch.randn(t.shape, generator=gen, device=ctx.device, dtype=t.dtype)
        for t in first[1:]]
    replay_err = max((a.double() - b.double()).abs().max().item()
                     for a, b in zip(first, replay))
    Yr, ref_out, flops = reference_run(ctx, X_lab, X_unl, steps, W0)
    if take is not None:  # a mesh's rank: its rows of the per-datapoint leaves
        elbos, g, W, own = ref_out
        ref_out = (elbos, {k: take[k](v) for k, v in g.items()},
                   {k: take[k](v) for k, v in W.items()}, own)
        W0 = {k: take[k](v) for k, v in W0.items()}
    lab = float(np.max(np.linalg.norm(Y_prog - Yr.cpu().numpy(), axis=1)
                       / np.linalg.norm(Yr.cpu().numpy(), axis=1)))
    prog = {"steps": steps, "grad1": grad1, "W0": W0, "W_end": W_end}
    ctx.check("label_rel_err", lab, tr["limits"]["label_rel_err"])
    ctx.check("draws_replay_err", replay_err,
              tr["limits"]["draws_replay_err"])
    numbers = compare(prog, ref_out)
    for name, value in numbers.items():
        if name in tr["limits"]:
            ctx.check(name, value, tr["limits"][name])
    ctx.counters["flops_per_step"] = flops
    ctx.kept = {"X_lab": X_lab, "X_unl": X_unl, "steps": steps, "prog": prog,
                "ref_out": ref_out, "numbers": numbers}


def detail(prog: dict, ref_out) -> dict:
    """The readings behind :func:`compare`: per-step errors of the two
    ELBO terms and the leaves with the largest gradient and change
    gaps."""
    elbos, g_ref, W_ref, labeled_only = ref_out
    per = {t: [abs(p[t] - r[t]) / abs(r[t]) for p, r in
               zip(prog["steps"], elbos)]
           for t in ("supervised", "unsupervised")}
    gnorm = {k: g.norm().item() for k, g in g_ref.items()}
    med = float(np.median(list(gnorm.values())))
    gaps = sorted(((abs(prog["grad1"][k].norm().item() - v) / max(v, med),
                    k, v) for k, v in gnorm.items()), reverse=True)[:6]
    W0 = prog["W0"]
    ch = sorted(((abs((prog["W_end"][k] - W0[k]).norm().item()
                      - (W_ref[k] - W0[k]).norm().item())
                  / max((W_ref[k] - W0[k]).norm().item(), 1e-30), k)
                 for k in gnorm), reverse=True)[:6]
    own = {k: "%.2e" % (abs(prog["grad1"][k].norm().item() - gnorm[k])
                        / max(gnorm[k], med)) for k in labeled_only}
    return {"per_step": per, "grad_gaps": gaps, "change_gaps": ch,
            "labeled_only": own,
            "grad_median": med,
            "ref_terms": [{t: r[t] for t in ("supervised", "unsupervised")}
                          for r in elbos]}


def diagnose(ctx) -> dict:
    k = ctx.kept
    return {"numbers": k["numbers"], **detail(k["prog"], k["ref_out"])}


def control(ctx) -> dict:
    """The numbers of the control: the plain reference in the program's
    place with TF32 on (the precision below the configuration's float32
    with TF32 off), against the reference as configured."""
    k = ctx.kept
    _, out, _ = reference_run(ctx, k["X_lab"], k["X_unl"], k["steps"],
                              k["prog"]["W0"], tf32=True)
    elbos, g1, W_end, _ = out
    ctrl = {"steps": elbos, "grad1": g1, "W0": k["prog"]["W0"],
            "W_end": W_end}
    return compare(ctrl, k["ref_out"])


def fault_readings(ctx) -> dict:
    """Each training fault planted in the reference put in the program's
    place, read by the same numbers against the reference."""
    k = ctx.kept
    out = {}
    for fault in ("state unchanged", "half the batch"):
        _, ref_out, _ = reference_run(ctx, k["X_lab"], k["X_unl"], k["steps"],
                                      k["prog"]["W0"], fault=fault)
        elbos, g1, W_end, _ = ref_out
        out[fault] = compare({"steps": elbos, "grad1": g1,
                              "W0": k["prog"]["W0"], "W_end": W_end},
                             k["ref_out"])
    return out


class FlopsByDtype(TorchDispatchMode):
    """Counts the floating-point operations of every op that
    ``torch.utils.flop_counter`` has a formula for, by the dtype of its
    first tensor argument (backward passes included)."""

    def __init__(self):
        super().__init__()
        self.flops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            dt = next((str(a.dtype).removeprefix("torch.") for a in args
                       if isinstance(a, torch.Tensor)), "float32")
            self.flops[dt] = self.flops.get(dt, 0) + int(
                f(*args, **kwargs, out_val=out))
        return out
