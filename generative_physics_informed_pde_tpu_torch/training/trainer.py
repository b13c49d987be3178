"""SVI training loop for the physics-informed generative model.

Port of ``Trainer`` / ``TrainerParameters`` and the ``CreateTrainer*`` glue
from ``generative_physics_informed_pde_tpu/training/trainer.py``.  One SVI
iteration (:meth:`Trainer.step`) first refreshes the virtual observables
when their cadence says so, then draws the unlabeled minibatch, takes the
gradient of the composite ELBO, steps ``torch.optim.Adam`` with the
schedule's learning rate, and every ``N_PE_interval``-th iteration runs the
prediction ensemble's inner Adam; the run loop monitors every
``N_monitor_interval`` iterations (a prediction-ensemble burst, then the
analyses) and ends with the final refinement and evaluation.  The training
draws come from one ``torch.Generator`` on the trainer's device, seeded by
``seed``; the virtual observables draw from their own, seeded by
``seed + 7919``, so turning them on does not shift the training draws.

Left out: the ``lax.scan`` chunking and its ``_SCAN_BUCKETS`` (a dispatch
device of the reference's jitted step; PyTorch runs eagerly), buffer
donation, mesh sharding, checkpointing, the plateau schedule and the
reduced-precision prediction-ensemble decode.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..constraints import build_virtual_observables_ensemble
from ..data.sampling import minibatch_indices
from ..factories.data import DataFactory
from ..factories.model import ModelFactory
from ..inference.analysis import Analysis
from ..inference.prediction import PredictionEnsemble
from ..utils.device import resolve_device
from .metrics import MetricsWriter
from .schedules import make_schedule

DEFAULT_CONFIG = dict(
    lr_init=None,
    normalize=False,
    l2_penalty=None,
    l1_penalty=None,
    N_PE_updates=3,
    N_PE_updates_final=100,
    # the prediction ensemble's inner Adam runs every k-th iteration; it
    # never feeds back into the model, and each monitor point first runs
    # a burst of N_PE_updates_monitor (None: 8 * N_PE_updates) iterations
    N_PE_interval=8,
    N_PE_updates_monitor=None,
    # 'auto' resolves to full precision below 128^2 fields, the only case
    # ported
    PE_compute_dtype="auto",
    N_monte_carlo_analysis=64,
    N_monte_carlo_analysis_final=128,
    N_monitor_interval=500,
    N_tensorboard_logging_interval=1,
    # virtual-observable refresh cadence: the JAX package's measured
    # default 50 (the reference uses 250)
    N_vo_update_interval=50,
    N_vo_holdoff=100,
    N_monte_carlo_vo=128,
    N_monte_carlo_elbo=1,
    MonitorTraining=True,
    halt_on_divergence=True,
)

DEBUG_CONFIG = dict(
    N_monitor_interval=5,
    N_PE_updates=1,
    N_PE_updates_final=5,
    N_monte_carlo_analysis=8,
    N_monte_carlo_analysis_final=16,
    N_monte_carlo_vo=16,
    N_tensorboard_logging_interval=1,
)


class TrainingDivergedError(RuntimeError):
    """Raised at a monitor point when the ELBO has gone non-finite."""


class TrainerParameters:
    """Config struct with the reference's three-tier dict layout."""

    def __init__(self):
        self.data = dict(N_u=0, N_s=None, N_vo=0, N_u_max=0, N_s_max=None,
                         N_vo_max=0, N_val=None, armortized_bs=None,
                         vo_spec=dict())
        self.scheduler = dict()
        self.trainer = dict()
        self.optimizer = dict()
        self.margs = dict()
        self.dargs = dict()
        self.identifier = None
        self.folder = None
        self.comment = ""
        self.debug = False
        self.Iterations = None
        self.seed = 0


class Trainer:
    """Orchestrates SVI on the composite ELBO on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``)."""

    def __init__(self, mf: ModelFactory, comment: str = "",
                 debug: bool = False, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self._mf = mf
        physics, model, discriminative, encoder, dtype = mf.setup(
            device=self.device,
            generator=torch.Generator().manual_seed(seed))
        self.physics = physics
        self.model = model
        self.discriminative_model = discriminative
        self.encoder = encoder
        self._dtype = dtype
        self.debug = debug
        self.comment = comment
        self.writer = MetricsWriter()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the virtual observables' own draws (the reference folds its
        # PRNGKey(seed + 7919) with the step)
        self.vo_generator = torch.Generator(
            device=self.device).manual_seed(seed + 7919)
        self.VO = None
        self._data_vo = None
        self._vo_state = None
        self._vo_is_initialized = False
        self._config = None
        self.datasets = None
        self._armortized_bs = None
        self._finalized = False
        self._global_runtime = 0.0
        self._global_iteration_counter = 0
        self._seed = seed
        # per-iteration ELBO as device scalars: no host sync per step
        self.elbo_history = []
        self.optimizer = None

    @classmethod
    def FromIdentifier(cls, identifier: str, margs=None, **kwargs):
        mf = ModelFactory.FromIdentifier(identifier)
        for key, val in (margs or {}).items():
            mf.set(key, val)
        return cls(mf=mf, **kwargs)

    # ------------------------------------------------------------ config
    def setup_config(self, **kwargs):
        self._config = dict(DEFAULT_CONFIG)
        for key, value in kwargs.items():
            if key not in self._config:
                raise KeyError(f"Could not set > {key} < in trainer config")
            self._config[key] = value

    @property
    def config(self) -> dict:
        if self._config is None:
            raise RuntimeError("Config has not yet been setup")
        if self.debug:
            return {**self._config, **DEBUG_CONFIG}
        return self._config

    def get(self, key):
        try:
            return self.config[key]
        except KeyError:
            raise KeyError(f"Could not retrieve > {key} < from trainer config")

    @property
    def dtype(self):
        return self._dtype

    @property
    def gn(self) -> int:
        return self._global_iteration_counter

    # --------------------------------------------------------------- data
    def set_data_from_datasets(self, datasets, Nu, Ns, Nvo, VO=None,
                               vo_spec=None, armortized_bs=None):
        """Restrict the chunks to the requested sizes and, with ``Nvo >
        0``, build the virtual observables of ``vo_spec`` on the 'vo'
        chunk (or take the ensemble ``VO``)."""
        if "validation" not in datasets or datasets["validation"].N == 0:
            raise ValueError("a non-empty validation chunk is required")
        if not all(v is not None and v >= 0 for v in (Nu, Ns, Nvo)):
            raise ValueError(f"N_u, N_s, N_vo must be >= 0, got "
                             f"{(Nu, Ns, Nvo)}")
        datasets["supervised"].restrict(Ns)
        if Ns == 0:
            # zero-label regime: the supervised term is disabled, the
            # empty chunk keeps its 0-row posterior
            self.model.disable_elbo_supervised = True
        if Nvo > 0:
            if "vo" not in datasets or datasets["vo"].N == 0:
                raise ValueError("N_vo > 0 needs a non-empty vo chunk "
                                 "(N_vo_max > 0)")
            datasets["vo"].restrict(Nvo)
            if VO is None:
                VO = build_virtual_observables_ensemble(
                    vo_spec, datasets["vo"], self.physics, dtype=self._dtype)
        else:
            datasets.pop("vo", None)
        self.VO = VO
        if Nu > 0:
            if "unsupervised" not in datasets \
                    or datasets["unsupervised"].N == 0:
                raise ValueError("N_u > 0 needs a non-empty unsupervised "
                                 "chunk")
            datasets["unsupervised"].restrict(Nu)
            if armortized_bs is None:
                raise NotImplementedError(
                    "the non-amortized unsupervised term is not ported "
                    "yet; set armortized_bs")
        else:
            datasets.pop("unsupervised", None)
            armortized_bs = None
        if armortized_bs is not None and self.encoder is None:
            raise RuntimeError("amortized batch size set but factory has no"
                               " encoder")
        self._armortized_bs = armortized_bs
        self.datasets = datasets

    # -------------------------------------------------------------- setup
    def setup(self, scheduler_spec: Optional[dict] = None):
        """Create the posteriors, the optimisers and the analyses."""
        if self._config is None:
            raise RuntimeError("Config has not yet been setup")
        if scheduler_spec and "patience" in scheduler_spec:
            raise NotImplementedError(
                "the plateau schedule is not ported yet")
        if self.get("l1_penalty") is not None:
            raise NotImplementedError(
                "l1_penalty is declared but not implemented (the "
                "reference raises as well); use l2_penalty")
        if self.get("N_monte_carlo_elbo") != 1:
            raise NotImplementedError("only N_monte_carlo_elbo=1 is ported")
        lr = self.get("lr_init")
        self._schedule = make_schedule(scheduler_spec, lr)

        ds = self.datasets
        keys = ("X", "Y", "F_ROM_BC")
        data_sup = {k: ds["supervised"].get(k) for k in keys}
        if data_sup["X"] is None:
            data_sup = {k: torch.zeros(
                (0,) + tuple(ds["validation"].get(k).shape[1:]),
                dtype=self._dtype, device=self.device) for k in keys}
        X_unsup = None
        if "unsupervised" in ds and ds["unsupervised"].N > 0:
            X_unsup = ds["unsupervised"].get("X")
        self._data_sup, self._X_unsup = data_sup, X_unsup
        self._data_vo = None
        if self.VO is not None:
            self._data_vo = {k: ds["vo"].get(k) for k in ("X", "F_ROM_BC")}

        init_sets = {"supervised": {"X": data_sup["X"]}}
        if X_unsup is not None:
            init_sets["unsupervised"] = {"X": X_unsup}
        if self._data_vo is not None:
            init_sets["vo"] = {"X": self._data_vo["X"]}
        self.model.init_params(init_sets)
        self._params = list(self.model.parameters())
        self.optimizer = torch.optim.Adam(self._params, lr=self._schedule(0))

        X_val = ds["validation"].get("X")
        pe_dt = self.get("PE_compute_dtype")
        if not (pe_dt is None or (pe_dt == "auto"
                                  and min(X_val.shape[-2:]) < 128)):
            raise NotImplementedError(
                "a reduced-precision prediction-ensemble decode is not "
                "ported yet")
        # the PE's Adam advances N_PE_updates counts per active iteration,
        # N_PE_updates / N_PE_interval per iteration on average
        pe_sched = make_schedule(
            scheduler_spec, lr,
            steps_per_update=(self.get("N_PE_updates")
                              / max(1, int(self.get("N_PE_interval") or 1))))
        self._PE = PredictionEnsemble(self.model, X_val, pe_sched)

        data_val = {k: ds["validation"].get(k) for k in keys}
        self._data_val = data_val
        self._analysis = Analysis(self.model, data_val, "validation",
                                  self.writer)
        self._analysis_training = Analysis(self.model, data_sup, "training",
                                           self.writer)
        self._analysis_encoder = None
        if self.model.encoder is not None:
            self._analysis_encoder = Analysis(
                self.model, data_val, "validation_encoder", self.writer)
        self.writer.logging_interval = self.get(
            "N_tensorboard_logging_interval")

    # --------------------------------------------------------------- step
    def step(self) -> Dict[str, torch.Tensor]:
        """One SVI iteration -> its logs (device tensors): the VO refresh
        when due, then the gradient step on the ELBO, whose VO term is held
        off (``logL_x - DKL`` only) before ``N_vo_holdoff`` iterations and
        until the first refresh."""
        model = self.model
        if self.update_vo():
            self.update_virtual_observables(self.gn)
        data = {"supervised": self._data_sup}
        if self._X_unsup is not None:
            idx = minibatch_indices(self.generator, self._X_unsup.shape[0],
                                    self._armortized_bs,
                                    device=self.device)
            data["unsupervised"] = {"X": self._X_unsup[idx]}
        vo_state, holdoff = None, False
        if self.use_vo():
            data["vo"] = self._data_vo
            holdoff = (self.gn < self.get("N_vo_holdoff")
                       or not self._vo_is_initialized)
            vo_state = self._vo_state or (None, None)
        self.optimizer.zero_grad(set_to_none=True)
        elbo, logs = model.elbo(data, self.generator, vo_state=vo_state,
                                vo_holdoff=holdoff,
                                normalize=self.get("normalize"),
                                l2_penalty=self.get("l2_penalty"))
        (-elbo).backward()
        for p in self._params:
            if p.grad is None:  # optax updates moments on zero gradients
                p.grad = torch.zeros_like(p)
        for group in self.optimizer.param_groups:
            group["lr"] = self._schedule(self.gn)
        self.optimizer.step()

        interval = int(self.get("N_PE_interval") or 1)
        if interval <= 1 or self.gn % interval == 0:
            pe_elbo, pe_logL = self._PE.update(self.get("N_PE_updates"),
                                               self.generator)
        else:
            # skipped iterations log NaN; the monitor burst refreshes them
            pe_elbo = pe_logL = torch.full((), math.nan, dtype=self._dtype,
                                           device=self.device)
        logs = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                for k, v in logs.items()}
        logs.update(self._pe_logs(pe_elbo, pe_logL))
        self._global_iteration_counter += 1
        self.elbo_history.append(logs["elbo"])
        return logs

    def _pe_logs(self, pe_elbo, pe_logL) -> dict:
        return {"PredictionEnsemble/elbo": pe_elbo,
                "PredictionEnsemble/logL": pe_logL,
                "PredictionEnsemble/KLD": pe_logL - pe_elbo,
                "PredictionEnsemble/AvgLatentStddev": torch.mean(
                    torch.exp(self._PE.q["logsigma"].detach()))}

    # ---------------------------------------------------------------- VO
    def use_vo(self) -> bool:
        return self.VO is not None and self._data_vo is not None

    def update_vo(self) -> bool:
        """The refresh cadence: from ``N_vo_holdoff`` on, every
        ``N_vo_update_interval`` iterations and at the first chance."""
        if not self.use_vo():
            return False
        return (self.gn >= self.get("N_vo_holdoff")
                and (self.gn % self.get("N_vo_update_interval") == 0
                     or not self._vo_is_initialized))

    @torch.no_grad()
    def update_virtual_observables(self, step: int, resample: bool = True):
        """Monte-Carlo propagate q through gp o g, redraw the test
        functions, then condition the VO posterior; the propagation and the
        test functions draw from ``vo_generator``."""
        Y_mean, Y_std = self.model.propagate_vo_moments(
            self._data_vo, self.vo_generator, self.get("N_monte_carlo_vo"))
        if resample:
            self.VO.resample(self.vo_generator)
        self.VO.update(Y_mean, 1.0 / (Y_std ** 2), step, writer=self.writer)
        self._vo_state = (self.VO.mean, self.VO.logsigma)
        self._vo_is_initialized = True

    # ---------------------------------------------------------------- run
    def run(self, N: int, verbose: bool = True, callback=None):
        """``N`` SVI iterations, then the final refinement and
        evaluation."""
        if self._finalized:
            raise RuntimeError("Cannot run trainer which has already been"
                               " finalized")
        t_start = time.time()
        try:
            self._run_loop(N, verbose, callback)
        finally:
            self._global_runtime += time.time() - t_start

    def _run_loop(self, N: int, verbose: bool, callback):
        mi = self.get("N_monitor_interval")
        for n in range(N):
            logs = self.step()
            if mi > 0 and n % mi == 0 and n > 0:
                elbo = float(logs["elbo"])
                if not np.isfinite(elbo) and self.get("halt_on_divergence"):
                    raise TrainingDivergedError(
                        f"non-finite ELBO at iteration {n} -- training "
                        "diverged (set trainer config halt_on_divergence="
                        "False to keep stepping anyway)")
                logs = self._pe_monitor_burst(logs)
                self._record(logs)
                if verbose:
                    print(f"Step: {n} / {N} || ELBO= {elbo:.4g} || "
                          "LogScore(y): "
                          f"{self._analysis.series['logscore_y'].final():.4g}")
            if callback is not None:
                callback(n, self.gn)
        n_final = self.get("N_PE_updates_final") * self.get("N_PE_updates")
        if n_final > 0:
            self._PE.update(n_final, self.generator)
        self._analysis.eval_all_y(
            self._PE.q, self.generator,
            self.get("N_monte_carlo_analysis_final"),
            iteration=self.gn + self.get("N_PE_updates_final"))

    # ---------------------------------------------------------- monitoring
    def _pe_monitor_burst(self, logs: dict) -> dict:
        """With N_PE_interval > 1, re-converge the PE posterior to the
        current parameters before the monitor analysis and log the
        post-burst PE metrics."""
        if int(self.get("N_PE_interval") or 1) <= 1:
            return logs
        n_burst = self.get("N_PE_updates_monitor")
        if n_burst is None:
            n_burst = 8 * self.get("N_PE_updates")
        if n_burst <= 0:
            return {k: v for k, v in logs.items()
                    if not (k.startswith("PredictionEnsemble")
                            and not math.isfinite(float(v)))}
        pe_elbo, pe_logL = self._PE.update(int(n_burst), self.generator)
        return {**logs, **self._pe_logs(pe_elbo, pe_logL)}

    @torch.no_grad()
    def _record(self, logs: dict):
        gn = self.gn
        self.writer.add_scalars(logs, gn, prefix="objective/")
        params_q_X = self.model.q_X
        if self.model.independent_X and "supervised" in params_q_X \
                and params_q_X["supervised"]["mean"].numel():
            qX = params_q_X["supervised"]
            self.writer.add_scalar("Monitoring/logEffProp_sup_mean",
                                   qX["mean"].mean(), gn)
            self.writer.add_scalar("Monitoring/logEffProp_sup_sigma",
                                   qX["logsigma"].mean(), gn)
        self.writer.add_scalar(
            "Monitoring/S_avg_precisions",
            torch.mean(1.0 / torch.exp(self.model.g.logsigmas_y) ** 2), gn)
        self.writer.add_scalar("Monitoring/lr", self._schedule(gn), gn)

        n_mc = self.get("N_monte_carlo_analysis")
        self._analysis.eval_all_y(self._PE.q, self.generator, n_mc,
                                  iteration=gn)
        if self.get("MonitorTraining") and self._data_sup["X"].shape[0] > 0:
            self._analysis_training.eval_all_y(
                self.model.q_z["supervised"], self.generator, n_mc,
                iteration=gn)
            if self._analysis_encoder is not None:
                with torch.no_grad():
                    mean, logsigma = self.model.apply_encoder(
                        self._data_val["X"], train=False)
                # the reference uses the final MC count at this site
                logscore, r2, relerr = self._analysis_encoder.eval_all_y(
                    {"mean": mean, "logsigma": logsigma}, self.generator,
                    self.get("N_monte_carlo_analysis_final"))
                self.writer.add_scalar("validation_encoder/logscore_y",
                                       logscore, gn)
                self.writer.add_scalar("validation_encoder/r2_y", r2, gn)
                self.writer.add_scalar("validation_encoder/relerr_y", relerr,
                                       gn)

    def elbos(self) -> torch.Tensor:
        """The ELBO of every iteration so far, on the host."""
        if not self.elbo_history:
            return torch.zeros(0)
        return torch.stack(self.elbo_history).cpu()

    def results(self, analysis: Optional[Analysis] = None) -> dict:
        analysis = analysis or self._analysis
        out = {k: analysis.series[k].final()
               for k in ("relerr_y", "r2_y", "logscore_y")}
        out["runtime"] = self._global_runtime
        return out

    def finalize(self):
        try:
            results = self.results()
        except IndexError:
            pass  # the run ended before the first analysis pass
        else:
            self.writer.add_hparams({"dummy": 0}, results)
        self._finalized = True

    def export_surrogate(self, *, buckets=None):
        """The discriminative surrogate as a ``serving.SurrogateBundle``
        over a frozen copy of the current weights (the reference's
        StableHLO file export is not ported yet)."""
        from ..serving import DEFAULT_BUCKETS, SurrogateBundle

        if self.optimizer is None:
            raise RuntimeError("call setup()/run() before exporting")
        img = self.physics["fom"].grid.nx
        return SurrogateBundle.build(
            self.discriminative_model, (img, img),
            self.physics["rom"].grid.n_nodes,
            buckets=DEFAULT_BUCKETS if buckets is None else buckets,
            dtype=self._dtype, device=self.device)

    def info(self):  # pragma: no cover
        ds = self.datasets or {}
        print("============ MODEL INFO ==============")
        for name in ("unsupervised", "supervised", "vo", "validation"):
            n = ds[name].N if name in ds and ds[name] else 0
            print(f"N_{name}: {n}")
        print(f"Armortization: {self.model.encoder is not None}")
        print(f"Dtype: {self._dtype}")
        print("========================================")


# ---------------------------------------------------------------------------
# Glue functions
# ---------------------------------------------------------------------------

def CreateTrainer(params: TrainerParameters, dl, dlu,
                  device="cuda") -> Trainer:
    return CreateTrainerFromPermutation(
        params, permutation=np.arange(dl.N), permutation_u=np.arange(dlu.N),
        dl=dl, dlu=dlu, device=device)


def CreateTrainerFromPermutation(params: TrainerParameters, permutation=None,
                                 permutation_u=None, dl=None, dlu=None,
                                 datasets=None, device="cuda") -> Trainer:
    trainer = Trainer.FromIdentifier(
        params.identifier, params.margs, comment=params.comment,
        debug=params.debug, seed=params.seed, device=device)
    if datasets is None:
        _, _, datasets = CreateDataSetsFromPermutation(
            params.identifier, permutation, permutation_u,
            params.data["N_val"], params.data["N_u_max"],
            params.data["N_s_max"], params.data["N_vo_max"],
            trainer.physics, None, trainer.dtype, dl=dl, dlu=dlu,
            device=trainer.device)
    trainer.set_data_from_datasets(
        datasets, params.data["N_u"], params.data["N_s"],
        params.data["N_vo"], vo_spec=params.data["vo_spec"],
        armortized_bs=params.data["armortized_bs"])
    trainer.setup_config(**params.trainer)
    trainer.setup(scheduler_spec=params.scheduler or None)
    return trainer


def CreateDataSetsFromPermutation(identifier, permutation, permutation_u,
                                  N_val, N_u_max, N_s_max, N_vo_max, physics,
                                  BCE, dtype, dl=None, dlu=None,
                                  device="cuda"):
    """Label the labeled pool, partition it into supervised / vo /
    validation chunks (the JAX order; 'vo' only with ``N_vo_max > 0``) and
    the unlabeled pool into one chunk -> (dl, dlu, datasets)."""
    device = resolve_device(device)
    if dl is None or dlu is None:
        dl, dlu = DataFactory.FromIdentifier(identifier).setup(
            N_u_max=N_u_max or None,
            generator=torch.Generator().manual_seed(1), device=device)
    if dl._Y is None:  # skip when the labels were already assembled
        dl.assemble(physics, BCE=BCE)
    if permutation is not None and len(dl) != len(permutation):
        raise ValueError(f"permutation has {len(permutation)} entries for "
                         f"{len(dl)} supervised fields")
    if permutation_u is not None and len(dlu) != len(permutation_u):
        raise ValueError(f"permutation_u has {len(permutation_u)} entries "
                         f"for {len(dlu)} unsupervised fields")
    partition = {"supervised": N_s_max}
    if N_vo_max > 0:
        partition["vo"] = N_vo_max
    partition["validation"] = N_val
    dl.randomized_partition(partition, identifier="default",
                            permutation=permutation)
    datasets = dl.construct_dataset_dictionary(identifier="default",
                                               dtype=dtype, device=device)
    if N_u_max > 0:
        dlu.randomized_partition({"unsupervised": N_u_max},
                                 identifier="default",
                                 permutation=permutation_u)
        datasets["unsupervised"] = dlu.construct_dataset_dictionary(
            identifier="default", dtype=dtype,
            device=device)["unsupervised"]
    return dl, dlu, datasets
