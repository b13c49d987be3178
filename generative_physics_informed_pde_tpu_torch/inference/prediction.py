"""Test-time inference for held-out data (the "prediction ensemble").

Port of ``PredictionEnsemble`` from
``generative_physics_informed_pde_tpu/inference/prediction.py``: a fresh
per-datapoint posterior ``q`` over the validation fields, optimised by its
own Adam against the reconstruction-only ELBO ``logL_x - KLD``.  Only
``q`` is optimised: the gradients are taken with respect to it alone, and
the decoder runs in train mode (batch statistics) with its updated running
statistics thrown away, as the reference discards them.  ``compute_dtype``
is the hot loop's decode precision: the updates with ``final=True`` and a
decoder without a compute dtype (the linear and MLP ones) run at full
precision.  Only ``q`` is optimised, so a reduced-precision decode here
never touches the training trajectory.

In a sharded run (``split``, a ``parallel.layout.RowSplit`` set by the
trainer) ``q`` and its Adam's moments hold this process's rows of the
validation fields, which stay whole on every process: the draws are made
for all of them and cut, the decodes take their BatchNorm statistics over
all of them, and ``update`` returns the ELBO summed over the processes.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import variational as va


class PredictionEnsemble:
    """``q`` (an ``nn.ParameterDict``) and its Adam, driven by
    ``schedule(count) -> lr`` with the optax count (update n uses
    ``schedule(n)``)."""

    def __init__(self, model, X: torch.Tensor, schedule: Callable,
                 compute_dtype=None):
        self.model = model
        self.X = X
        self.schedule = schedule
        self.compute_dtype = compute_dtype
        self.q = va.init_variational(X.shape[0], model.dim_latent,
                                     dtype=X.dtype, device=X.device)
        self.optimizer = torch.optim.Adam(self.q.parameters(),
                                          lr=schedule(0))
        self.count = 0
        self.split = None

    def state_dict(self) -> dict:
        """``q``, its Adam's state and the update count."""
        return {"q": self.q.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.q.load_state_dict(state["q"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])

    def _bn_buffers(self):
        return [b for name, b in self.model.f.named_buffers()
                if name.endswith(("running_mean", "running_var"))]

    def _decode_dtype(self, final: bool):
        if final or self.compute_dtype is None \
                or not hasattr(self.model.f, "compute_dtype"):
            return None
        return self.compute_dtype

    def elbo(self, q, generator=None, final: bool = False):
        """Reconstruction-only ELBO -> (elbo, logL) (this process's share
        when sharded)."""
        split = self.split
        if split is None:
            Z, X = va.sample(q, generator), self.X
        else:
            Z, X = va.sample_rows(q, generator, split), split.take(self.X)
        saved = [b.clone() for b in self._bn_buffers()]
        predict_x = self.model.apply_decoder(
            Z, train=True, generator=generator,
            compute_dtype=self._decode_dtype(final), split=split)
        with torch.no_grad():  # the reference discards the stats update
            for b, s in zip(self._bn_buffers(), saved):
                b.copy_(s)
        logL = self.model.random_field_likelihood(predict_x, X)
        return logL - va.kld(q), logL

    def update(self, num_iter: int, generator=None, final: bool = False):
        """``num_iter`` Adam steps on q only -> (last elbo, last logL),
        each as of before its step (detached); ``final`` decodes at full
        precision."""
        params = [self.q["mean"], self.q["logsigma"]]
        elbo = logL = torch.zeros((), dtype=self.X.dtype,
                                  device=self.X.device)
        for _ in range(num_iter):
            elbo, logL = self.elbo(self.q, generator, final)
            grads = torch.autograd.grad(-elbo, params)
            for p, g in zip(params, grads):
                p.grad = g
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.count)
            self.optimizer.step()
            self.count += 1
            elbo, logL = elbo.detach(), logL.detach()
        if self.split is not None and self.split.group is not None:
            elbo, logL = self.split.sum(torch.stack([elbo, logL]))
        return elbo, logL
