"""The semi-supervised physics-informed VAE and its composite ELBO.

Port of ``GenerativeModel`` and ``DiscriminativeModel`` from
``generative_physics_informed_pde_tpu/models/generative.py``.  The JAX
package's parameter pytree becomes the module tree: the decoder ``f``, the
amortized ``encoder``, the property map ``gp``, the ROM operator ``g`` and
the per-datapoint posteriors ``q_z`` / ``q_X`` (``nn.ParameterDict``s
holding ``mean`` and ``logsigma``), all optimised by one Adam; the
BatchNorm statistics are the modules' buffers, updated in place by every
train-mode decode in the order the reference chains them.

Options of the JAX package's model, as it defines them:

* ``n_mc``: Monte-Carlo samples of the supervised term per ELBO, folded
  into the batch N-major (the data repeated in ``jnp.repeat``'s order);
  each likelihood is divided by ``n_mc``, the KLD and the entropy are not.
* ``unsup_compute_dtype``: the codec's compute dtype in the unsupervised
  terms (amortized and not), in train mode only; the supervised and VO
  terms and eval mode run at full precision.
* ``fuse_decodes``: one decode over the concatenated z-samples of the
  active terms (BatchNorm batch statistics over all of them in train
  mode) at full precision.  Every posterior draw of the terms is made
  before it, in the order the unfused terms make them, so that in eval
  mode the fused ELBO equals the unfused one bit for bit; in train mode
  the dropout masks are drawn once for the fused batch.  Fewer than two
  active terms keep the unfused semantics.
* ``remat_codec``: train-mode codec applies under ``codec.checkpointed``
  (activations recomputed in the backward pass, the same math).
* ``layout`` / ``mc_sharding`` (set by ``Trainer.setup(mesh=...)``): the
  per-datapoint posteriors and the data hold this process's rows of a
  sharded run (``parallel.layout.TrainLayout``).  Every draw is made for
  the whole batch and cut to the local rows, every train-mode codec
  apply takes its BatchNorm statistics over the whole batch
  (``codec.row_split``), and the ELBO is this process's share: the sum
  over the processes of their shares is the unsharded ELBO (a batch that
  repeats on a mesh's replicas is counted by the first replica, the l2
  penalty by process 0).  The amortized minibatch comes with its split
  (``data['unsupervised']['split']``), which may be uneven.  With
  ``mc_sharding`` (a ``Sharding`` from ``parallel.mc_batch_sharding``) the
  supervised (N * n_mc) Monte-Carlo batch is split over all mesh axes,
  unevenly where it does not divide, and ``fuse_decodes`` is ignored, as
  in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..inference import variational as va
from ..inference.likelihoods import (bernoulli_log_likelihood,
                                     diagonal_gaussian_log_likelihood,
                                     reparametrize, reparametrize_rows,
                                     unit_gaussian_kld)
from ..parallel.layout import RowSplit
from .codec import checkpointed, row_split
from .components import (EffectivePropertyMap, ReducedOrderModelOperator,
                         propagate_gp_samples)


def _dtype_for(module, compute_dtype):
    """``compute_dtype`` where ``module`` supports one, else None (the
    linear and MLP codecs run at their own precision)."""
    if compute_dtype is None or not hasattr(module, "compute_dtype"):
        return None
    return compute_dtype


class GenerativeModel(nn.Module):
    """Decoder f, ROM operator g, property map gp, optional amortized
    encoder, and the per-datapoint posteriors created by
    :meth:`init_params`."""

    def __init__(self, g: ReducedOrderModelOperator,
                 gp: EffectivePropertyMap,
                 encoder: Optional[nn.Module] = None,
                 f: Optional[nn.Module] = None, *,
                 independent_X: bool = True, binary_field: bool = False,
                 reconstruct_log_eff_property: bool = True, n_mc: int = 1,
                 fuse_decodes: bool = False, remat_codec: bool = False,
                 unsup_compute_dtype=None):
        super().__init__()
        self.n_mc = n_mc
        self.fuse_decodes = fuse_decodes
        self.remat_codec = remat_codec
        self.unsup_compute_dtype = unsup_compute_dtype
        self.f = f
        self.g = g
        self.gp = gp
        self.encoder = encoder
        self.q_z = nn.ModuleDict()
        self.q_X = nn.ModuleDict()
        self.independent_X = independent_X
        self.binary_field = binary_field
        self.reconstruct_log_eff_property = reconstruct_log_eff_property
        self.disable_elbo_supervised = False
        self.disable_elbo_unsupervised = False
        self.disable_elbo_vo = False
        self.layout = None
        self.mc_sharding = None

    # ------------------------------------------------------------- shapes
    @property
    def dim_latent(self) -> int:
        return self.f.dim_latent

    @property
    def dim_effective_property(self) -> int:
        return self.g.dim_effective_property

    @property
    def dim_y(self) -> int:
        return self.g.dim_out

    # ------------------------------------------------------- param init
    def init_params(self, datasets: Dict[str, dict]) -> "GenerativeModel":
        """Create the per-datapoint posteriors (zero mean and logsigma) in
        the model's dtype on its device: ``q_z`` for the labeled, the
        virtual-observable (and, when not amortized, unlabeled) data, ``q_X``
        for the labeled and virtual-observable data when ``independent_X``.
        ``datasets`` maps modality -> dict with 'X'."""
        ref = next(self.gp.parameters())
        for name, data in datasets.items():
            if data is None:
                continue
            N = data["X"].shape[0]
            if name == "unsupervised" and self.encoder is not None:
                continue  # amortized: no per-datapoint q_z
            if name in ("supervised", "unsupervised", "vo"):
                self.q_z[name] = va.init_variational(
                    N, self.dim_latent, dtype=ref.dtype, device=ref.device)
            if self.independent_X and name in ("supervised", "vo"):
                self.q_X[name] = va.init_variational(
                    N, self.dim_effective_property, dtype=ref.dtype,
                    device=ref.device)
        return self

    # ------------------------------------------------------- applications
    def _run_codec(self, module, x, train, generator, compute_dtype,
                   split=None):
        module.train(train)
        kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
        # a batch no other process holds part of runs the plain apply
        with row_split(split if train and split is not None
                       and split.group is not None else None):
            if train and self.remat_codec:
                return checkpointed(lambda x: module(x, generator, **kw), x)
            return module(x, generator, **kw)

    def apply_decoder(self, z, *, train: bool, generator=None,
                      compute_dtype=None, split=None):
        """Decode in train mode (batch statistics, running-stat update,
        dropout masks from ``generator``) or eval mode (running
        statistics, no dropout); ``compute_dtype`` overrides the
        decoder's.  ``split``: the rows of a sharded batch ``z`` holds
        (``parallel.layout.RowSplit``)."""
        return self._run_codec(self.f, z, train, generator, compute_dtype,
                               split)

    def apply_encoder(self, x, *, train: bool = False, generator=None,
                      compute_dtype=None, split=None):
        return self._run_codec(self.encoder, x, train, generator,
                               compute_dtype, split)

    # ------------------------------------------------------ sharded rows
    def _block(self, n_local: int):
        """The split of a per-datapoint block (a posterior or its data) of
        ``n_local`` rows a process (None unsharded)."""
        return None if self.layout is None else self.layout.block(n_local)

    def _mc_split(self):
        """The split of the supervised decode's rows: the Monte-Carlo rows
        over all axes under ``mc_sharding``, else over the batch axes."""
        if self.layout is None:
            return None
        n = self._n_global(self.q_z["supervised"]["mean"].shape[0])
        if self.mc_sharding is not None:
            return self.layout.joint(n, self.n_mc)
        return self.layout.rows(n * self.n_mc)

    def _sample(self, q, generator):
        split = self._block(q["mean"].shape[0])
        if split is None:
            return va.sample(q, generator)
        return va.sample_rows(q, generator, split)

    @staticmethod
    def _reparametrize(generator, mean, logsigma, split):
        if split is None:
            return reparametrize(generator, mean, logsigma)
        return reparametrize_rows(generator, mean, logsigma, split)

    def _n_global(self, n_local: int) -> int:
        """The rows of a per-datapoint block of ``n_local`` rows a
        process."""
        return n_local if self.layout is None \
            else self.layout.block(n_local).n

    def _once(self, x):
        """``x``, a sum over a per-datapoint block, where this process
        counts it: zero on a replica other than the first (no gradient)."""
        if self.layout is None or self.layout.first_replica:
            return x
        return torch.zeros_like(torch.as_tensor(x)).detach()

    @staticmethod
    def _dropped(logs):
        """A term this process computed but does not count: zero, with the
        same logs, all zero."""
        return 0.0, {k: torch.zeros_like(torch.as_tensor(v)).detach()
                     for k, v in logs.items()}

    def _unsup_dtypes(self, train: bool):
        """(decoder, encoder) compute dtypes of the unsupervised terms:
        ``unsup_compute_dtype`` in train mode where the codec takes one."""
        dt = self.unsup_compute_dtype if train else None
        return _dtype_for(self.f, dt), _dtype_for(self.encoder, dt)

    def apply_gp(self, z):
        return self.gp(z)

    def apply_g(self, effprop, F):
        return self.g(effprop, F)

    # ---------------------------------------------------- likelihood of x
    def random_field_likelihood(self, predict, target):
        """Gaussian on the log field (or the exp field), or Bernoulli."""
        if self.binary_field:
            return bernoulli_log_likelihood(predict, target)
        mean, logsigma = predict
        if self.reconstruct_log_eff_property:
            return diagonal_gaussian_log_likelihood(target, mean,
                                                    2 * logsigma)
        return diagonal_gaussian_log_likelihood(
            torch.exp(target), torch.exp(mean), 2 * logsigma)

    # ------------------------------------------------------- ELBO pieces
    def _mc_sample(self, q, generator):
        """``n_mc`` draws per datapoint of ``q``, N-major (N * n_mc, dim),
        or one draw per datapoint; under ``mc_sharding`` this process's
        block of the rows of its datapoints."""
        if self.n_mc > 1:
            Z = va.sample_all_components_rows(
                q, generator, self.n_mc, self._block(
                    q["mean"].shape[0])).reshape(-1, q["mean"].shape[-1])
            if self.mc_sharding is not None:
                Z = self.layout.replica_block(Z)
            return Z
        return self._sample(q, generator)

    def elbo_supervised(self, data, generator=None, *, train: bool = True,
                        normalize: bool = False, fused=None):
        """Labeled-pair term -> (elbo, logs).  ``fused``: the draws
        ('Z', 'X') and the decode ('predict_x') of the fused decode."""
        if self.disable_elbo_supervised:
            return 0.0, {}
        X, Y, F_ = data["X"], data["Y"], data["F_ROM_BC"]
        qz = self.q_z["supervised"]
        S = self.n_mc
        if fused is None:
            Z = self._mc_sample(qz, generator)
            predict_x = self.apply_decoder(Z, train=train,
                                           generator=generator,
                                           split=self._mc_split())
        else:
            Z, predict_x = fused["Z"], fused["predict_x"]
        if S > 1:
            X, Y, F_ = (t.repeat_interleave(S, 0) for t in (X, Y, F_))
            if self.mc_sharding is not None:
                X, Y, F_ = (self.layout.replica_block(t) for t in (X, Y, F_))
        logL_x = self.random_field_likelihood(predict_x, X) / S
        DKL = self._once(va.kld(qz))
        if self.independent_X:
            qX = self.q_X["supervised"]
            X_sample = fused["X"] if fused else self._mc_sample(qX,
                                                                generator)
            mu_X, logsigmas_X = self.apply_gp(Z)
            logL_X = diagonal_gaussian_log_likelihood(
                X_sample, mu_X, 2 * logsigmas_X) / S
            ent = self._once(va.entropy(qX))
        else:
            X_sample = self.apply_gp(Z)
            logL_X = 0.0
            ent = 0.0
        mu_y, logsigmas_y = self.apply_g(X_sample, F_)
        logL_y = diagonal_gaussian_log_likelihood(Y, mu_y,
                                                  2 * logsigmas_y) / S
        if normalize:
            bs = self._n_global(data["X"].shape[0])
            logL_x, logL_y, logL_X, ent, DKL = (
                v / bs for v in (logL_x, logL_y, logL_X, ent, DKL))
        elbo = logL_x + logL_y + logL_X + ent - DKL
        logs = {"supervised_logL_x": logL_x, "supervised_logL_y": logL_y,
                "supervised_DKL_z": DKL, "supervised_elbo": elbo}
        if self.independent_X:
            logs.update({"supervised_logL_X": logL_X,
                         "supervised_entropy_X": ent})
        return elbo, logs

    def elbo_unsupervised_amortized(self, X_batch, generator=None, *,
                                    train: bool = True,
                                    normalize: bool = False, fused=None,
                                    split=None):
        """Amortized unlabeled term on a minibatch -> (elbo, logs).
        ``fused``: the encoder's ('Z' = (mean, logsigma)) and the decode
        ('predict_x') of the fused decode.  ``split``: sharded, the rows
        of the minibatch that ``X_batch`` holds (a ``RowSplit``)."""
        if self.disable_elbo_unsupervised:
            return 0.0, {}
        if self.layout is not None and split is None:
            raise ValueError("a sharded minibatch needs its split")
        if fused is None:
            dec_dt, enc_dt = self._unsup_dtypes(train)
            mean, logsigma = self.apply_encoder(
                X_batch, train=train, generator=generator,
                compute_dtype=enc_dt, split=split)
            Z = self._reparametrize(generator, mean, logsigma, split)
            predict_x = self.apply_decoder(Z, train=train,
                                           generator=generator,
                                           compute_dtype=dec_dt, split=split)
        else:
            (mean, logsigma), predict_x = fused["Z"], fused["predict_x"]
        logL_x = self.random_field_likelihood(predict_x, X_batch)
        DKL = unit_gaussian_kld(mean, 2 * logsigma)
        if normalize:
            bs = X_batch.shape[0] if split is None else split.n
            logL_x, DKL = logL_x / bs, DKL / bs
        elbo = logL_x - DKL
        return elbo, {"ARM_unsupervised_logL_x": logL_x,
                      "ARM_unsupervised_DKL_z": DKL,
                      "ARM_unsupervised_elbo": elbo}

    def elbo_unsupervised(self, X, generator=None, *, train: bool = True,
                          normalize: bool = False):
        """Non-amortized unlabeled term over the per-datapoint posterior
        ``q_z['unsupervised']`` -> (elbo, logs).  Its KLD is that of
        ``q_z['unsupervised']``: the JAX package's fix of the original
        code, which took the supervised posterior's."""
        if self.disable_elbo_unsupervised:
            return 0.0, {}
        qz = self.q_z["unsupervised"]
        Z = self._sample(qz, generator)
        predict_x = self.apply_decoder(
            Z, train=train, generator=generator,
            compute_dtype=self._unsup_dtypes(train)[0],
            split=self._block(Z.shape[0]))
        logL_x = self.random_field_likelihood(predict_x, X)
        DKL = va.kld(qz)
        if normalize:
            bs = self._n_global(X.shape[0])
            logL_x, DKL = logL_x / bs, DKL / bs
        elbo = logL_x - DKL
        return elbo, {"unsupervised_logL_x": logL_x,
                      "unsupervised_DKL_z": DKL,
                      "unsupervised_elbo": elbo}

    def elbo_virtual_observables(self, data, generator=None, *, vo_mean,
                                 vo_logsigma, holdoff: bool = False,
                                 train: bool = True,
                                 normalize: bool = False, fused=None):
        """Virtual-observable term -> (elbo, logs): the VO posterior
        (vo_mean, vo_logsigma) over y stands in for labels through a
        reparameterised draw.  With ``holdoff`` only ``logL_x - DKL``
        remains (the VO posterior is not used).  ``fused``: the draws
        ('Z', 'X', 'y') and the decode ('predict_x') of the fused
        decode."""
        if self.disable_elbo_vo:
            return 0.0, {}
        X, F_ = data["X"], data["F_ROM_BC"]
        qz = self.q_z["vo"]
        if fused is None:
            Z = self._sample(qz, generator)
            predict_x = self.apply_decoder(Z, train=train,
                                           generator=generator,
                                           split=self._block(Z.shape[0]))
        else:
            Z, predict_x = fused["Z"], fused["predict_x"]
        DKL = va.kld(qz)
        logL_x = self.random_field_likelihood(predict_x, X)
        if holdoff:
            logL_y = logL_X = ent = 0.0
        else:
            if self.independent_X:
                qX = self.q_X["vo"]
                X_sample = fused["X"] if fused else self._sample(qX,
                                                                 generator)
                mu_X, logsigmas_X = self.apply_gp(Z)
                logL_X = diagonal_gaussian_log_likelihood(
                    X_sample, mu_X, 2 * logsigmas_X)
                ent = va.entropy(qX)
            else:
                X_sample = self.apply_gp(Z)
                logL_X = ent = 0.0
            mu_y, logsigmas_y = self.apply_g(X_sample, F_)
            y_sample = fused["y"] if fused else self._vo_y_sample(
                vo_mean, vo_logsigma, generator)
            logL_y = diagonal_gaussian_log_likelihood(y_sample, mu_y,
                                                      2 * logsigmas_y)
        if normalize:
            bs = self._n_global(X.shape[0])
            logL_x, logL_y, logL_X, ent, DKL = (
                v / bs for v in (logL_x, logL_y, logL_X, ent, DKL))
        elbo = logL_x + logL_y + logL_X + ent - DKL
        logs = {"vo_logL_x": logL_x, "vo_logL_y": logL_y, "vo_DKL": DKL,
                "vo_elbo": elbo}
        if self.independent_X:
            logs.update({"vo_logL_X": logL_X, "vo_entropy_X": ent})
        return elbo, logs

    # --------------------------------------------------------- full ELBO
    def elbo(self, data, generator=None, *, vo_state=None,
             vo_holdoff: bool = False, train: bool = True,
             normalize: bool = False, l2_penalty: Optional[float] = None):
        """Composite ELBO -> (elbo, logs).  ``data`` maps modality ->
        tensors; 'unsupervised' is already the minibatch.  The terms run
        unlabeled, labeled, virtual observables (when ``data`` has 'vo' and
        ``vo_state`` = (vo_mean, vo_logsigma) is given), so the decodes
        update the BatchNorm statistics in the reference's order.  With a
        ``layout``, this process's share of the ELBO and of each log."""
        total = 0.0
        logs = {}
        vo_active = data.get("vo") is not None and vo_state is not None
        # a batch repeated on the replicas counts on the first one only
        once = self.layout is None or self.layout.first_replica
        fused = {}
        # without the encoder the unsupervised decode is not part of the
        # fused batch, and its BatchNorm update must not be dropped
        if self.fuse_decodes and self.mc_sharding is None \
                and (self.encoder is not None
                     or data.get("unsupervised") is None):
            fused = self._fused_decode(data, generator, vo_state=vo_state,
                                       vo_holdoff=vo_holdoff, train=train)
        if data.get("unsupervised") is not None:
            X_u = data["unsupervised"]["X"]
            if self.encoder is not None:
                e, lg = self.elbo_unsupervised_amortized(
                    X_u, generator, train=train, normalize=normalize,
                    fused=fused.get("u"),
                    split=data["unsupervised"].get("split"))
            else:
                e, lg = self.elbo_unsupervised(X_u, generator, train=train,
                                               normalize=normalize)
            if not once:
                e, lg = self._dropped(lg)
            total += e
            logs.update(lg)
        if data.get("supervised") is not None:
            e, lg = self.elbo_supervised(data["supervised"], generator,
                                         train=train, normalize=normalize,
                                         fused=fused.get("s"))
            if not once and self.mc_sharding is None:
                e, lg = self._dropped(lg)
            total += e
            logs.update(lg)
        if vo_active:
            vo_mean, vo_logsigma = vo_state
            e, lg = self.elbo_virtual_observables(
                data["vo"], generator, vo_mean=vo_mean,
                vo_logsigma=vo_logsigma, holdoff=vo_holdoff, train=train,
                normalize=normalize, fused=fused.get("v"))
            if not once:
                e, lg = self._dropped(lg)
            total += e
            logs.update(lg)
        if l2_penalty is not None:
            pen = _l2_norm_sum(self.f)
            if self.encoder is not None:
                pen = pen + _l2_norm_sum(self.encoder)
            if self.layout is not None and not self.layout.lead:
                pen = torch.zeros_like(pen).detach()  # counted once
            total = total - l2_penalty * pen
            logs["elbo_l2_penalty"] = pen
        logs["elbo"] = total
        return total, logs

    def _vo_y_sample(self, vo_mean, vo_logsigma, generator):
        """One draw of y per VO datapoint from the VO posterior, whose
        moments hold this process's rows, as the VO data and posteriors
        do: the normals drawn whole, this process's rows kept."""
        dt = self.q_z["vo"]["mean"].dtype
        return self._reparametrize(generator, vo_mean.to(dt),
                                   vo_logsigma.to(dt),
                                   self._block(vo_mean.shape[0]))

    def _fused_decode(self, data, generator, *, vo_state, vo_holdoff: bool,
                      train: bool) -> dict:
        """ONE full-precision decode over the z-samples of the active
        terms -> {term: {'Z', 'predict_x' and the term's other draws}}
        for the terms 'u', 's' and 'v', or {} when fewer than two are
        active (nothing is drawn then).  The draws are made in the unfused
        terms' order; the unlabeled term's 'Z' is its encoder output."""
        names = []
        if data.get("unsupervised") is not None \
                and self.encoder is not None \
                and not self.disable_elbo_unsupervised:
            names.append("u")
        if data.get("supervised") is not None \
                and not self.disable_elbo_supervised:
            names.append("s")
        if data.get("vo") is not None and vo_state is not None \
                and not self.disable_elbo_vo:
            names.append("v")
        if len(names) < 2:
            return {}
        fused, parts, splits = {}, [], []
        for name in names:
            if name == "u":
                X_u = data["unsupervised"]["X"]
                splits.append(data["unsupervised"].get("split"))
                head = self.apply_encoder(X_u, train=train,
                                          generator=generator,
                                          split=splits[-1])
                parts.append(self._reparametrize(generator, *head,
                                                 splits[-1]))
                fused["u"] = {"Z": head}
            elif name == "s":
                splits.append(self._mc_split())
                parts.append(self._mc_sample(self.q_z["supervised"],
                                             generator))
                fused["s"] = {"Z": parts[-1]}
                if self.independent_X:
                    fused["s"]["X"] = self._mc_sample(
                        self.q_X["supervised"], generator)
            else:
                parts.append(self._sample(self.q_z["vo"], generator))
                splits.append(self._block(parts[-1].shape[0]))
                fused["v"] = {"Z": parts[-1]}
                if not vo_holdoff:
                    if self.independent_X:
                        fused["v"]["X"] = self._sample(self.q_X["vo"],
                                                       generator)
                    fused["v"]["y"] = self._vo_y_sample(*vo_state,
                                                        generator)
        split = None
        if self.layout is not None:
            split = RowSplit.concat(splits)
        out = self.apply_decoder(torch.cat(parts), train=train,
                                 generator=generator, split=split)
        lo = 0
        for name, Z in zip(names, parts):
            hi = lo + Z.shape[0]
            fused[name]["predict_x"] = tuple(o[lo:hi] for o in out) \
                if isinstance(out, tuple) else out[lo:hi]
            lo = hi
        return fused

    # ------------------------------------------------ VO moment propagation
    def propagate_vo_moments(self, data_vo, generator, n_monte_carlo: int,
                             q=None):
        """Monte-Carlo push of q through gp o g for every VO sample at once
        -> (Y_mean, Y_std), each (N_vo, dim_y).  ``q``: the VO posterior
        to push (default the model's ``q_X['vo']``, or ``q_z['vo']``
        without ``independent_X``), over the rows of ``data_vo``.  With a
        ``layout``, ``data_vo`` and ``q`` hold this process's rows: the
        draws are made for all ``N_vo * n_monte_carlo`` samples and cut, so
        this process decodes and solves its own rows' samples and returns
        their moments."""
        if n_monte_carlo < 2:
            # std with one degree of freedom over one sample is NaN, which
            # would poison the VO precision downstream
            raise ValueError("N_monte_carlo_vo must be >= 2 "
                             f"(got {n_monte_carlo})")
        F_ = data_vo["F_ROM_BC"]
        N = F_.shape[0]
        if q is None:
            q = self.q_X["vo"] if self.independent_X else self.q_z["vo"]
        split = self._block(N)  # None: all rows
        mc = split and split.repeat(n_monte_carlo)
        Xs = va.sample_all_components_rows(q, generator, n_monte_carlo,
                                           split)  # (N, S, c or dz)
        if not self.independent_X:
            gp_out = self.apply_gp(Xs.reshape(-1, Xs.shape[-1]))
            Xs = propagate_gp_samples(gp_out, generator, split=mc).reshape(
                N, n_monte_carlo, -1)
        F_rep = F_[:, None, :].expand(N, n_monte_carlo, F_.shape[-1])
        # g's push-through (``self.g.propagate_samples``), drawn for all
        # the rows of a sharded batch as the gp's samples are
        Ys = propagate_gp_samples(self.g(
            Xs.reshape(N * n_monte_carlo, -1),
            F_rep.reshape(N * n_monte_carlo, -1)), generator, split=mc)
        Ys = Ys.reshape(N, n_monte_carlo, -1)
        return Ys.mean(dim=1), Ys.std(dim=1, correction=1)


def _l2_norm_sum(module: nn.Module) -> torch.Tensor:
    """Sum of per-parameter L2 norms, with the gradient 0 (not NaN) at an
    all-zero parameter, as the reference defines it."""
    total = 0.0
    for p in module.parameters():
        sq = torch.sum(torch.square(p))
        safe = torch.where(sq > 0, sq, torch.ones_like(sq))
        total = total + torch.where(sq > 0, torch.sqrt(safe),
                                    torch.zeros_like(sq))
    return total


class DiscriminativeModel(nn.Module):
    """Deterministic x -> y surrogate extracted from a generative model:
    ``y = g(gp_mean(encoder_mean(x)), F)``."""

    def __init__(self, model: GenerativeModel):
        super().__init__()
        self.model = model

    @torch.no_grad()
    def forward(self, x, F_, *, use_encoder: bool = True):
        if use_encoder:
            if self.model.encoder is None:
                raise RuntimeError("encoder is not set")
            z, _ = self.model.apply_encoder(x, train=False)
        else:
            z = x  # x is already a latent encoding
        gp_out = self.model.apply_gp(z)
        X_c = gp_out[0] if isinstance(gp_out, tuple) else gp_out
        mu_y, _ = self.model.apply_g(X_c, F_)
        return mu_y
