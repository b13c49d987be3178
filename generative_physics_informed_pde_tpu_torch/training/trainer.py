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
draws (minibatch indices, the ELBO's samples, dropout masks, the step's
prediction-ensemble update) come from one ``torch.Generator`` on the
trainer's device, seeded by ``seed``; the virtual observables draw from
their own, seeded by ``seed + 7919``, so turning them on does not shift the
training draws.  Each monitor point and the final refinement and analysis
draw from a fresh generator seeded from ``(seed + c, gn)`` (the reference's
``fold_in(PRNGKey(seed + c), gn)``), so how a run is split into ``run``
calls does not change its training draws.  ``save_checkpoint`` /
``restore_checkpoint`` (``checkpoint.py``) carry everything a resumed run
needs, the generators' states included.

``N_monte_carlo_elbo`` sets the model's ``n_mc``; ``PE_compute_dtype``
('auto': bf16 from 128^2 fields on) is the prediction ensemble's hot-loop
decode precision, its final refinement runs at full precision; a
scheduler spec with ``patience`` selects the plateau schedule, stepped on
the ELBO at the monitor points; without ``armortized_bs`` the unlabeled
term is the non-amortized one over the whole unlabeled chunk (the model
drops its encoder).

``setup(mesh=...)`` trains sharded over the processes of a mesh
(``parallel.make_mesh`` / ``make_hybrid_mesh``), with the JAX package's
layout: the data and the per-datapoint posteriors (with their Adam
moments, and the prediction ensemble's) hold each process's rows of the
mesh's batch axes, the network weights are whole on every process.  The
step computes on local tensors with explicit collectives: every draw is
made whole and cut to the local rows (the generators stay equal on every
process and equal to the unsharded run's), the BatchNorm statistics and
the logged ELBO terms are sums over the processes, the gradients of the
whole parameters are summed over all processes before Adam (those of the
per-datapoint blocks over the processes holding the same rows), and the
unlabeled minibatch is drawn whole and each process takes its share of
its rows, gathered from the processes that hold them, or from a whole
unlabeled set.  The virtual observables and the analyses split as the
JAX package's layout splits them: each process propagates, conditions or
iterates the VO rows it holds (the constrain arm's test functions and
their assembly, its precision hyperprior and the energy arm's K_diag stay
whole on every process), and the training and validation analyses
evaluate each process's rows of their data and posteriors and sum their
metrics over the processes; the encoder analysis, whose posterior the
encoder makes from the whole validation set, runs whole on every
process.  Only process 0 writes metrics, checkpoints and exports; a
checkpoint holds the whole state, the layout of an unsharded one, and
restores on any mesh.  Batches without per-datapoint state may split
unevenly over the batch axes' shards, as GSPMD lays them out
(``parallel.layout``): the amortized minibatch (``armortized_bs``), the
unlabeled set of the amortized term (kept whole on every process) and
the Monte-Carlo rows under ``mc_batch_sharding``.
``N_s``, ``N_val``, ``N_vo`` and the non-amortized ``N_u`` size
per-datapoint blocks, which must divide by the shard count: setup
refuses them otherwise, as the JAX package does.

Left out: the ``lax.scan`` chunking and its ``_SCAN_BUCKETS`` (a dispatch
device of the reference's jitted step; PyTorch runs eagerly) and buffer
donation.
"""

from __future__ import annotations

import math
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..constraints import build_virtual_observables_ensemble
from ..data.sampling import gather_rows, minibatch_indices
from ..factories.data import DataFactory
from ..factories.model import ModelFactory
from ..inference.analysis import Analysis
from ..inference.prediction import PredictionEnsemble
from ..parallel.distributed import all_reduce_sum, barrier, process_index
from ..parallel.layout import TrainLayout
from ..parallel.mesh import (mc_batch_sharding, map_state_blocks,
                             shard_data_dict, shard_train_state)
from ..utils.device import resolve_device
from ..utils.time import span
from .metrics import MetricsWriter
from .schedules import PlateauController, make_schedule

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
    # prediction-ensemble hot-loop decode dtype: 'auto' resolves to bf16
    # from 128^2 fields on and to full precision below
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


def resolve_pe_compute_dtype(pe_dt, x_shape):
    """The ``PE_compute_dtype`` config value against the validation field
    shape (..., py, px): 'auto' is bf16 from 128^2 on, else None (full
    precision); a dtype string is resolved."""
    if isinstance(pe_dt, str) and pe_dt == "auto":
        pe_dt = "bfloat16" if min(x_shape[-2:]) >= 128 else None
    if isinstance(pe_dt, str):
        from ..factories.model import fetch_dtype
        return fetch_dtype(pe_dt)
    return pe_dt


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

    def __init__(self, mf: ModelFactory, folder: Optional[str] = None,
                 comment: str = "", debug: bool = False, seed: int = 0,
                 device="cuda"):
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
        # in a group of processes only process 0 writes the metrics file
        if folder is not None and process_index() != 0:
            folder = None
        self.writer = MetricsWriter(folder, comment=comment)
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
        self._dl = None
        self._dlu = None
        self._armortized_bs = None
        self._finalized = False
        self._global_runtime = 0.0
        self._global_iteration_counter = 0
        self._seed = seed
        # per-iteration ELBO as device scalars: no host sync per step
        self.elbo_history = []
        # host values at the monitor points, where the host already waits
        self._monitor = dict(elbo=[], elbo_iter=[], lr=[], lr_iter=[])
        self.optimizer = None
        self._plateau = None
        self._mesh = None
        self._layout = None

    @classmethod
    def FromIdentifier(cls, identifier: str, margs=None, dargs=None,
                       **kwargs):
        mf = ModelFactory.FromIdentifier(identifier)
        for key, val in (margs or {}).items():
            mf.set(key, val)
        if dargs:
            # as in the JAX package and its reference, where dargs is
            # unused: warn rather than discard it silently
            warnings.warn(
                "TrainerParameters.dargs is accepted for reference parity "
                "but has no effect; configure data via DataFactory presets "
                "or pass dl/dlu explicitly", stacklevel=2)
        return cls(mf=mf, **kwargs)

    from_identifier = FromIdentifier

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

    def tinfo(self, N: Optional[int] = None):
        """Average seconds per iteration, and the projection for ``N``."""
        if self.gn == 0:
            return
        avg = self._global_runtime / self.gn
        print(f"{self.gn} iterations in {self._global_runtime} seconds : "
              f"that makes on average {avg} seconds per iteration")
        if N is not None:
            print(f"Will require (approx) {avg * N} for {N} iterations")

    def reset(self):
        raise NotImplementedError  # as the reference

    @property
    def mf(self) -> ModelFactory:
        return self._mf

    @property
    def dl(self):
        """The labeled loader the datasets were partitioned from (None
        when the datasets came without it)."""
        return self._dl

    @property
    def dlu(self):
        """The unlabeled loader (None when the datasets came without
        it)."""
        return self._dlu

    def _monitor_generator(self, offset: int) -> torch.Generator:
        """A generator on the trainer's device for the draws of one monitor
        point or of the final refinement and analysis, seeded from
        ``(seed + offset, gn)``: offsets 13 (final PE refinement), 17
        (final analysis), 37 (monitor PE burst) and 23 (monitor analyses),
        as the reference's stateless keys."""
        return torch.Generator(device=self.device).manual_seed(
            ((self._seed + offset) << 32) + self.gn)

    # --------------------------------------------------------------- data
    def set_data_from_datasets(self, datasets, Nu, Ns, Nvo, VO=None,
                               vo_spec=None, armortized_bs=None, dl=None,
                               dlu=None):
        """Restrict the chunks to the requested sizes and, with ``Nvo >
        0``, build the virtual observables of ``vo_spec`` on the 'vo'
        chunk (or take the ensemble ``VO``); ``dl`` / ``dlu``, the loaders
        the chunks come from, are kept for ``Trainer.dl`` / ``dlu``."""
        self._dl, self._dlu = dl, dlu
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
        else:
            datasets.pop("unsupervised", None)
            armortized_bs = None
        if armortized_bs is not None and self.encoder is None:
            raise RuntimeError("amortized batch size set but factory has no"
                               " encoder")
        if armortized_bs is None and Nu > 0:
            # the non-amortized term: a per-datapoint q_z, no encoder
            self.model.encoder = None
        self._armortized_bs = armortized_bs
        self.datasets = datasets

    # -------------------------------------------------------------- setup
    def setup(self, scheduler_spec: Optional[dict] = None, mesh=None):
        """Create the posteriors, the optimisers and the analyses.

        ``mesh``: train sharded over the mesh's batch axes
        (``parallel.batch_pspec``; the module docstring has the layout).
        The posteriors are built whole, as without a mesh, then cut to
        this process's rows (``parallel.shard_train_state``) before the
        optimiser is made.  With ``N_monte_carlo_elbo > 1`` and an 'mc'
        axis the supervised Monte-Carlo batch is split over all axes
        (``parallel.mc_batch_sharding``).  A one-device mesh runs this
        path and equals ``setup()`` bit for bit."""
        if self._config is None:
            raise RuntimeError("Config has not yet been setup")
        if self.get("l1_penalty") is not None:
            raise NotImplementedError(
                "l1_penalty is declared but not implemented (the "
                "reference raises as well); use l2_penalty")
        lr = self.get("lr_init")
        self._plateau = None
        spec = scheduler_spec
        if spec and "patience" in spec:
            # ReduceLROnPlateau: the host scales the lr at monitor points;
            # the prediction ensemble's lr stays constant
            self._plateau = PlateauController(
                patience=spec["patience"],
                threshold=spec.get("threshold", 1e-3),
                factor=spec.get("factor", 0.1),
                min_lr=spec.get("min_lr", 1e-3),
                mode=spec.get("mode", "max"), lr_init=lr)
            spec = None
        self._schedule = make_schedule(spec, lr)
        self.model.n_mc = self.get("N_monte_carlo_elbo")
        self._mesh = mesh
        layout = self._layout = None if mesh is None else TrainLayout(mesh)
        self.model.layout = self.model.mc_sharding = None
        self.optimizer = None

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
        data_vo = None
        if self.VO is not None:
            data_vo = {k: ds["vo"].get(k) for k in ("X", "F_ROM_BC")}
        X_val = ds["validation"].get("X")
        init_sets = {"supervised": {"X": data_sup["X"]}}
        if X_unsup is not None:
            init_sets["unsupervised"] = {"X": X_unsup}
        if data_vo is not None:
            init_sets["vo"] = {"X": data_vo["X"]}
        self._N_u = 0 if X_unsup is None else X_unsup.shape[0]
        n_sup = data_sup["X"].shape[0]
        if layout is not None:
            self._check_splits(layout, data_sup, data_vo, X_unsup, X_val)
            data_sup = shard_data_dict(data_sup, mesh)
            if data_vo is not None:
                data_vo = shard_data_dict(data_vo, mesh)
            if X_unsup is not None:
                X_unsup = shard_data_dict({"X": X_unsup}, mesh)["X"]
        self._data_sup, self._X_unsup, self._data_vo = (data_sup, X_unsup,
                                                        data_vo)
        if self.VO is not None and (layout is not None
                                    or self.VO.split is not None):
            self.VO.shard(layout)  # its moments hold the VO rows

        self.model.init_params(init_sets)
        # the PE's Adam advances N_PE_updates counts per active iteration,
        # N_PE_updates / N_PE_interval per iteration on average
        pe_sched = make_schedule(
            spec, lr,
            steps_per_update=(self.get("N_PE_updates")
                              / max(1, int(self.get("N_PE_interval") or 1))))
        self._PE = PredictionEnsemble(
            self.model, X_val, pe_sched,
            compute_dtype=resolve_pe_compute_dtype(
                self.get("PE_compute_dtype"), X_val.shape))
        if layout is not None:
            shard_train_state(self, mesh)
            self._PE.split = layout.block(self._PE.q["mean"].shape[0])
            if self.model.n_mc > 1 and "mc" in mesh.mesh_dim_names:
                self.model.mc_sharding = mc_batch_sharding(mesh)
            self.model.layout = layout
        self._params = list(self.model.parameters())
        self.optimizer = torch.optim.Adam(self._params, lr=self._schedule(0))

        data_val = {k: ds["validation"].get(k) for k in keys}
        self._data_val = data_val
        # the validation and training analyses evaluate this process's
        # rows of the posteriors they are given (the JAX package's output
        # lies P('dp')); the validation data is whole on every process
        val_split = self._rows_split(X_val.shape[0])
        self._analysis = Analysis(
            self.model, data_val if val_split is None
            else {k: val_split.take(v) for k, v in data_val.items()},
            "validation", self.writer, split=val_split)
        self._analysis_training = Analysis(
            self.model, self._data_sup, "training", self.writer,
            split=self._rows_split(n_sup))
        self._analysis_encoder = None
        if self.model.encoder is not None:
            self._analysis_encoder = Analysis(
                self.model, data_val, "validation_encoder", self.writer)
        self.writer.logging_interval = self.get(
            "N_tensorboard_logging_interval")

    def _check_splits(self, layout, data_sup, data_vo, X_unsup, X_val):
        """Every per-datapoint block divides by the batch axes' shard
        count: the posteriors of ``N_s``, ``N_val`` (the prediction
        ensemble's), ``N_vo`` and the non-amortized ``N_u``, where the
        JAX package refuses too."""
        layout.check_rows("N_s", data_sup["X"].shape[0])
        layout.check_rows("N_val", X_val.shape[0])
        if data_vo is not None:
            layout.check_rows("N_vo", data_vo["X"].shape[0])
        if X_unsup is not None and self.model.encoder is None:
            layout.check_rows("N_u", X_unsup.shape[0])

    def _rows_split(self, n: int):
        """The split of a whole dataset of ``n`` rows over the batch axes
        that an analysis evaluates (None unsharded or on one shard)."""
        L = self._layout
        return None if L is None or L.k_rows == 1 else L.rows(n)

    def _gathered(self, tree):
        """Every process's rows of the sharded tensors of ``tree`` (a
        dict of tensors or a posterior), whole and detached; ``tree``
        itself unsharded."""
        if self._layout is None:
            return tree
        return {k: self._layout.gather(v.detach()) for k, v in tree.items()}

    # --------------------------------------------------------------- step
    def step(self) -> Dict[str, torch.Tensor]:
        """One SVI iteration -> its logs (device tensors): the VO refresh
        when due, then the gradient step on the ELBO, whose VO term is held
        off (``logL_x - DKL`` only) before ``N_vo_holdoff`` iterations and
        until the first refresh.  Sharded, the logs are the sums over the
        processes.  Spans: ``trainer.step`` around it, and inside
        ``trainer.vo_refresh``, ``trainer.elbo``, ``trainer.backward``,
        ``trainer.reduce_grads``, ``trainer.optimizer``,
        ``trainer.pe_update`` and ``trainer.logs``."""
        with span("trainer.step"):
            return self._step()

    def _step(self) -> Dict[str, torch.Tensor]:
        model = self.model
        if self.update_vo():
            with span("trainer.vo_refresh"):
                self.update_virtual_observables(self.gn)
        data = {"supervised": self._data_sup}
        if self._X_unsup is not None and model.encoder is None:
            data["unsupervised"] = {"X": self._X_unsup}
        elif self._X_unsup is not None:
            idx = minibatch_indices(self.generator, self._N_u,
                                    self._armortized_bs, device=self.device)
            X_u, split = self._minibatch(idx)
            data["unsupervised"] = {"X": X_u, "split": split}
        vo_state, holdoff = None, False
        if self.use_vo():
            data["vo"] = self._data_vo
            holdoff = (self.gn < self.get("N_vo_holdoff")
                       or not self._vo_is_initialized)
            vo_state = self._vo_state or (None, None)
        self.optimizer.zero_grad(set_to_none=True)
        with span("trainer.elbo"):
            elbo, logs = model.elbo(data, self.generator, vo_state=vo_state,
                                    vo_holdoff=holdoff,
                                    normalize=self.get("normalize"),
                                    l2_penalty=self.get("l2_penalty"))
        with span("trainer.backward"):
            if torch.is_tensor(elbo) and elbo.requires_grad:
                (-elbo).backward()  # a mesh's replica may count no term
            for p in self._params:
                if p.grad is None:  # optax updates moments on zero grads
                    p.grad = torch.zeros_like(p)
        with span("trainer.reduce_grads"):
            self._reduce_grads()
        with span("trainer.optimizer"):
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(self.gn)
            self.optimizer.step()

        interval = int(self.get("N_PE_interval") or 1)
        if interval <= 1 or self.gn % interval == 0:
            with span("trainer.pe_update"):
                pe_elbo, pe_logL = self._PE.update(self.get("N_PE_updates"),
                                                   self.generator)
        else:
            # skipped iterations log NaN; the monitor burst refreshes them
            pe_elbo = pe_logL = torch.full((), math.nan, dtype=self._dtype,
                                           device=self.device)
        with span("trainer.logs"):
            logs = self._global_logs(
                {k: (v.detach() if isinstance(v, torch.Tensor) else v)
                 for k, v in logs.items()})
            logs.update(self._pe_logs(pe_elbo, pe_logL))
        self._global_iteration_counter += 1
        self.elbo_history.append(logs["elbo"])
        return logs

    def _minibatch(self, idx: torch.Tensor):
        """The unlabeled rows ``idx`` (drawn whole) this process computes
        with, and their split (None unsharded): all of them unsharded,
        else its share of the minibatch, taken from a whole unlabeled set
        or gathered from the processes that hold those rows."""
        L = self._layout
        if L is None:
            return self._X_unsup[idx], None
        share = L.rows(idx.shape[0])
        if self._X_unsup.shape[0] == self._N_u:  # whole on every process
            return self._X_unsup[share.take(idx)], share
        lo = L.r * self._X_unsup.shape[0]
        return share.take(gather_rows(self._X_unsup, idx, lo,
                                      L.rows_group)), share

    def _reduce_grads(self) -> None:
        """Sharded: the gradients of the whole parameters summed over all
        processes, those of the per-datapoint blocks over the processes
        that hold the same rows (the replicas)."""
        L = self._layout
        if L is None or L.world == 1:
            return
        blocks, whole = [], []
        for name, p in self.model.named_parameters():
            (blocks if name.split(".", 1)[0] in ("q_z", "q_X")
             else whole).append(p.grad)
        for grads, group in ((whole, L.world_group),
                             (blocks, L.replica_group)):
            if group is None or not grads:
                continue
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                                  group)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def _global_logs(self, logs: dict) -> dict:
        """Sharded: each log summed over the processes (each holds its
        share of every ELBO term)."""
        L = self._layout
        if L is None or L.world == 1:
            return logs
        keys = sorted(logs)
        vals = all_reduce_sum(torch.stack([
            torch.as_tensor(logs[k], dtype=self._dtype,
                            device=self.device).reshape(()) for k in keys]),
            L.world_group)
        return dict(zip(keys, vals.unbind()))

    def lr(self, step: int) -> float:
        """The learning rate of update ``step``: the schedule's, or
        ``lr_init`` times the plateau scale."""
        if self._plateau is not None:
            return self._plateau.lr_init * self._plateau.scale
        return self._schedule(step)

    def _pe_logs(self, pe_elbo, pe_logL) -> dict:
        return {"PredictionEnsemble/elbo": pe_elbo,
                "PredictionEnsemble/logL": pe_logL,
                "PredictionEnsemble/KLD": pe_logL - pe_elbo,
                "PredictionEnsemble/AvgLatentStddev": torch.mean(
                    torch.exp(self._pe_q()["logsigma"].detach()))}

    def _pe_q(self):
        """The prediction ensemble's posterior, whole."""
        return self._gathered(self._PE.q)

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
        test functions draw from ``vo_generator``.  Sharded, every process
        propagates and conditions the VO rows it holds (the draws made
        whole and cut; the test functions drawn and assembled whole)."""
        Y_mean, Y_std = self.model.propagate_vo_moments(
            self._data_vo, self.vo_generator, self.get("N_monte_carlo_vo"))
        if resample:
            self.VO.resample(self.vo_generator)
        self.VO.update(Y_mean, 1.0 / (Y_std ** 2), step, writer=self.writer)
        self._vo_state = (self.VO.mean, self.VO.logsigma)
        self._vo_is_initialized = True

    # ---------------------------------------------------------------- run
    def run(self, N: int, verbose: bool = True, callback=None,
            profile_dir: Optional[str] = None):
        """``N`` SVI iterations, then the final refinement and evaluation.

        ``profile_dir``: trace the run with ``torch.profiler`` (host
        activity, and the card's kernels when the trainer is on one) and
        write the trace into that directory with
        ``tensorboard_trace_handler``, for TensorBoard's profiler view or
        any Chrome-trace viewer.  The trace carries the port's
        ``gpipde.*`` spans (``utils.time.span``: the step's parts, the
        solves, the V-cycle levels, the monitor points and the final
        refinement), whose host totals ``utils.span_totals()`` then
        holds."""
        if self._finalized:
            raise RuntimeError("Cannot run trainer which has already been"
                               " finalized")
        prof = None
        if profile_dir is not None:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(
                               str(profile_dir)))
            prof.start()
        t_start = time.time()
        try:
            self._run_loop(N, verbose, callback)
        finally:
            # accrue the runtime and stop the trace even when the loop
            # raises: a profiler left running blocks every later one
            self._global_runtime += time.time() - t_start
            if prof is not None:
                prof.stop()

    def _run_loop(self, N: int, verbose: bool, callback):
        mi = self.get("N_monitor_interval")
        for n in range(N):
            logs = self.step()
            if mi > 0 and n % mi == 0 and n > 0:
                with span("trainer.monitor"):
                    elbo = float(logs["elbo"])
                    if not np.isfinite(elbo) \
                            and self.get("halt_on_divergence"):
                        raise TrainingDivergedError(
                            f"non-finite ELBO at iteration {n} -- training "
                            "diverged (set trainer config halt_on_divergence="
                            "False to keep stepping anyway)")
                    if self._plateau is not None:
                        self._plateau.step(elbo)
                        for group in self.optimizer.param_groups:
                            group["lr"] = self.lr(self.gn)
                    logs = self._pe_monitor_burst(logs)
                    self._record(logs)
                    if verbose:
                        score = self._analysis.series["logscore_y"].final()
                        print(f"Step: {n} / {N} || ELBO= {elbo:.4g} || "
                              f"LogScore(y): {score:.4g}")
            if callback is not None:
                callback(n, self.gn)
        # the final refinement and evaluation
        with span("trainer.finalize"):
            n_final = self.get("N_PE_updates_final") \
                * self.get("N_PE_updates")
            if n_final > 0:
                self._PE.update(n_final, self._monitor_generator(13),
                                final=True)
            self._analysis.eval_all_y(
                self._PE.q, self._monitor_generator(17),
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
        pe_elbo, pe_logL = self._PE.update(int(n_burst),
                                           self._monitor_generator(37))
        return {**logs, **self._pe_logs(pe_elbo, pe_logL)}

    @torch.no_grad()
    def _record(self, logs: dict):
        gn = self.gn
        self.writer.add_scalars(logs, gn, prefix="objective/")
        params_q_X = self.model.q_X
        if self.model.independent_X and "supervised" in params_q_X \
                and params_q_X["supervised"]["mean"].numel():
            qX = self._gathered(params_q_X["supervised"])
            self.writer.add_scalar("Monitoring/logEffProp_sup_mean",
                                   qX["mean"].mean(), gn)
            self.writer.add_scalar("Monitoring/logEffProp_sup_sigma",
                                   qX["logsigma"].mean(), gn)
        self.writer.add_scalar(
            "Monitoring/S_avg_precisions",
            torch.mean(1.0 / torch.exp(self.model.g.logsigmas_y) ** 2), gn)
        lr = self.lr(gn)
        self.writer.add_scalar("Monitoring/lr", lr, gn)
        self._monitor["elbo_iter"].append(gn)
        self._monitor["elbo"].append(float(logs["elbo"]))
        self._monitor["lr_iter"].append(gn)
        self._monitor["lr"].append(float(lr))

        n_mc = self.get("N_monte_carlo_analysis")
        generator = self._monitor_generator(23)
        self._analysis.eval_all_y(self._PE.q, generator, n_mc, iteration=gn)
        if self.get("MonitorTraining") and self._data_sup["X"].shape[0] > 0:
            self._analysis_training.eval_all_y(
                self.model.q_z["supervised"], generator, n_mc, iteration=gn)
            if self._analysis_encoder is not None:
                with torch.no_grad():
                    mean, logsigma = self.model.apply_encoder(
                        self._data_val["X"], train=False)
                # the reference uses the final MC count at this site
                logscore, r2, relerr = self._analysis_encoder.eval_all_y(
                    {"mean": mean, "logsigma": logsigma}, generator,
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
        self.writer.flush()
        self.writer.close()
        self._finalized = True

    # ------------------------------------------------- checkpoint / resume
    def save_checkpoint(self, path: str) -> str:
        """Write the whole training state to one file at ``path`` (returns
        its absolute path): the model's parameters, BatchNorm statistics
        and posteriors, Adam's state, the prediction ensemble (``q``, its
        Adam, its count), ``gn``, the runtime, the monitor series, the
        plateau controller, the states of both generators and the names
        of the optimised parameters in Adam's order.  Sharded, the
        per-datapoint blocks are gathered and process 0 writes the
        unsharded layout; every process returns after the write.

        The virtual observables' state rides along as another
        per-datapoint block (``vo``: the moments, the fallback mask and
        the constrain arm's precision hyperprior, whole), which goes
        beyond the reference: its checkpoint leaves the VO state out, so
        a resumed run reconditions from a fresh ensemble.  Here the first
        step after a restore reconditions too, from the restored state
        (the energy arm's iterate and the constrain arm's precision carry
        on)."""
        from .checkpoint import save_train_state

        if self.optimizer is None:
            raise RuntimeError("call setup() before saving a checkpoint")
        state = {"device_type": self.device.type,
                 "model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "param_names": [n for n, _ in
                                 self.model.named_parameters()],
                 "prediction_ensemble": self._PE.state_dict(),
                 "gn": self._global_iteration_counter,
                 "runtime": self._global_runtime,
                 "monitor": self._monitor,
                 "generator": self.generator.get_state(),
                 "vo_generator": self.vo_generator.get_state()}
        if self.VO is not None:
            state["vo"] = self.VO.moments()  # whole: gathered when sharded
        if self._plateau is not None:
            state["plateau"] = self._plateau.state_dict()
        if self._layout is None:
            return save_train_state(path, state)
        state = map_state_blocks(state, self._layout.gather)
        if process_index() == 0:
            save_train_state(path, state)
        barrier()
        return os.path.abspath(path)

    def restore_checkpoint(self, path: str):
        """Load a :meth:`save_checkpoint` file into this trainer, built
        as the one that wrote it, on any mesh (the blocks are cut for
        this trainer's).  A checkpoint written before the plateau or the
        VO state was kept leaves the controller or the ensemble as it
        is.  A generator's state is only valid on its device type, so a
        checkpoint from another device type is refused (``checkpoint.
        restore_encoder_decoder`` loads the codec's parameters across
        devices)."""
        from .checkpoint import restore_train_state

        if self.optimizer is None:
            raise RuntimeError("call setup() before restoring a checkpoint")
        state = restore_train_state(path)
        if state["device_type"] != self.device.type:
            raise ValueError(
                f"{path} was written by a trainer on "
                f"{state['device_type']!r}, this one runs on "
                f"{self.device.type!r}: its random generators' states do "
                "not carry over; restore on the device type that wrote it "
                "(restore_encoder_decoder loads the parameters alone)")
        if self._layout is not None:  # this process's rows of the blocks
            state.setdefault("param_names", [
                n for n, _ in self.model.named_parameters()])
            state = shard_train_state(state, self._mesh)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._PE.load_state_dict(state["prediction_ensemble"])
        if self.VO is not None and "vo" in state:
            self.VO.load_moments(state["vo"])  # cut to this process's rows
        self.generator.set_state(state["generator"])
        self.vo_generator.set_state(state["vo_generator"])
        if self._plateau is not None and "plateau" in state:
            self._plateau.load_state_dict(state["plateau"])
        self._global_iteration_counter = int(state["gn"])
        self._global_runtime = float(state["runtime"])
        self._monitor = {k: list(v) for k, v in state["monitor"].items()}
        self._vo_state = None
        self._vo_is_initialized = False

    def export_surrogate(self, path: Optional[str] = None, *, buckets=None,
                         platforms=None):
        """The discriminative surrogate as a ``serving.SurrogateBundle``
        over a frozen copy of the current weights, in the trainer's dtype
        on its device; with ``path`` also written there (one
        ``torch.export`` program per bucket and platform, see
        ``SurrogateBundle.save``; in a group of processes process 0 writes
        it, the weights being whole on every process).  ``platforms``: the
        torch device types to export for, e.g. ``("cuda", "cpu")``; None
        is the trainer's device alone."""
        from ..serving import DEFAULT_BUCKETS, SurrogateBundle

        if self.optimizer is None:
            raise RuntimeError("call setup()/run() before exporting")
        img = self.physics["fom"].grid.nx
        bundle = SurrogateBundle.build(
            self.discriminative_model, (img, img),
            self.physics["rom"].grid.n_nodes,
            buckets=DEFAULT_BUCKETS if buckets is None else buckets,
            dtype=self._dtype, device=self.device, platforms=platforms)
        if path is not None:
            if process_index() == 0:
                bundle.save(path)
            if self._layout is not None:
                barrier()
        return bundle

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
                                 datasets=None, BCE_encoding=None,
                                 device="cuda") -> Trainer:
    """A trainer of ``params`` on the labeled and unlabeled pools (a
    preset's when ``dl`` / ``dlu`` are None) partitioned by the
    permutations.  ``BCE_encoding``: (n, 4) boundary-condition encodings
    of the FOM's family, one per labeled field, which the labels are
    solved with in place of the loader's own draws."""
    trainer = Trainer.FromIdentifier(
        params.identifier, params.margs, params.dargs, folder=params.folder,
        comment=params.comment, debug=params.debug, seed=params.seed,
        device=device)
    BCE = None
    if BCE_encoding is not None:
        from ..fem.bc import BoundaryConditionEnsemble

        fom = trainer.physics["fom"]
        BCE = BoundaryConditionEnsemble.from_encoding(fom.physics_id,
                                                      BCE_encoding)
        BCE.register_function_space("fom", fom.grid)
        BCE.register_function_space("rom", trainer.physics["rom"].grid)
    if datasets is None:
        dl, dlu, datasets = CreateDataSetsFromPermutation(
            params.identifier, permutation, permutation_u,
            params.data["N_val"], params.data["N_u_max"],
            params.data["N_s_max"], params.data["N_vo_max"],
            trainer.physics, BCE, trainer.dtype, dl=dl, dlu=dlu,
            device=trainer.device)
    trainer.set_data_from_datasets(
        datasets, params.data["N_u"], params.data["N_s"],
        params.data["N_vo"], vo_spec=params.data["vo_spec"],
        armortized_bs=params.data["armortized_bs"], dl=dl, dlu=dlu)
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
