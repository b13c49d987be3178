"""Virtual observables: weak-form PDE residual constraints as free labels.

Port of ``generative_physics_informed_pde_tpu/constraints/virtual_observables.py``.
For an unlabeled conductivity field x the discrete PDE gives linear
constraints on the unknown solution, ``Gamma y = alpha`` with
``Gamma = V^T K_ff(x)`` and ``alpha = V^T f_eff`` for any test matrix V.
Conditioning the model's predictive Gaussian over y on these constraints
gives a virtual posterior that stands in for labels in the ELBO.

The ensemble state is stacked tensors (Gamma (N, m, d), alpha (N, m),
mean/vars (N, d)) on the physics' device.  ``Gamma`` is built matrix-free
as ``(K_ff V)^T`` (K is symmetric): the stencil coefficients of the N
fields are built once per assembly in the batch-last layout of the kernel
K1 (``ops/csrc/stencil.cu``), and K1 runs once per test column over the N
fields, so no coefficient grid is repeated per column.  The energy arm's
subspace iteration applies ``K_ff`` the same way.  On a CPU tensor every
apply runs K1's plain version.

Where the JAX package returns NaN from a failed Cholesky or solve,
``torch.linalg.cholesky_ex`` and ``solve_ex`` report it in ``info``; a
nonzero ``info`` turns that sample's result non-finite (constrain arm) or
keeps its previous iterate (energy arm), so the reference's per-sample
containment runs unchanged, on the device, without a host sync per
sample.  In f32 both packages share one limit: once the equilibrated
Schur matrix's condition number nears 1e7, its rounding error exceeds the
1e-6 jitter and a Cholesky completes or fails by rounding alone, so a
batched factorisation on a card can fail on a sample that a CPU replay
conditions; such a sample falls back to its prior moments, as in the JAX
package.  The einsums run in full precision on a card as long as TF32 stays
off for matmuls (PyTorch's default).

All random draws come from an explicit ``torch.Generator`` through the
module functions :func:`sketch_normals` (Gaussian sketches) and
:func:`rbf_uniforms` (RBF centres, also the energy arm's test functions),
which tests replace to inject draws.

In sharded training (``shard``, set by ``Trainer.setup(mesh=...)``) the
ensemble lies as the JAX package's layout places it: the moments
(``mean``, ``vars``, the fallback mask) and the energy arm's iterate hold
this process's rows of the mesh's batch axes, as the VO data and
posteriors do, and every process conditions or iterates its own rows
only.  What the JAX package keeps whole stays whole on every process: the
query points, the constrain arm's test functions and their assembly
(``Gamma``, ``alpha``: drawn and assembled whole, which keeps the draws in
step), its precision hyperprior (``_prec_beta``, ``vo_variances``: its
sums over the samples are summed over the processes) and the energy arm's
``K_diag``.  Every draw over the samples is made whole and cut, so the
generators stay equal to the unsharded run's.  The failure count and its
warning are global sums; ``GPIPDE_VO_DUMP`` is written by process 0 from
the gathered inputs.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..fem.assembly import apply_batch_last
from ..fem.physics import LinearEllipticPhysics
from ..parallel.distributed import all_reduce_sum
from .flux import FluxConstraintOperator


def sketch_normals(shape, generator: torch.Generator, dtype,
                   device) -> torch.Tensor:
    """Standard normals of ``shape`` from ``generator``, on ``device``."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def rbf_uniforms(shape, generator: torch.Generator, dtype,
                 device) -> torch.Tensor:
    """Uniforms on [0, 1) of ``shape`` from ``generator``, on ``device``."""
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=generator.device).to(device)


# ---------------------------------------------------------------------------
# Query-point ensemble
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuerryPointEnsemble:
    """Per unlabeled sample the log-field x (DG0) and its Dirichlet values,
    on the physics' device; K and f_eff are functions (matrix-free)."""

    physics: LinearEllipticPhysics
    X_DG: torch.Tensor        # (N, n_cells) log-conductivity
    bc_values: torch.Tensor   # (N, n_constrained) Dirichlet values

    def __post_init__(self):
        if self.X_DG.dim() != 2 or self.X_DG.shape[0] != \
                self.bc_values.shape[0]:
            raise ValueError(f"X_DG {tuple(self.X_DG.shape)} and bc_values "
                             f"{tuple(self.bc_values.shape)} do not match")
        if self.X_DG.device != self.physics.device:
            raise ValueError(f"X_DG is on {self.X_DG.device}, the physics "
                             f"on {self.physics.device}")
        self.bc_values = self.bc_values.to(self.X_DG)

    @property
    def N(self) -> int:
        return self.X_DG.shape[0]

    @property
    def dim_out(self) -> int:
        return self.physics.dim_out

    @property
    def device(self) -> torch.device:
        return self.X_DG.device

    @property
    def alpha(self) -> torch.Tensor:
        """exp(x): conductivities."""
        return torch.exp(self.X_DG)

    def _free(self) -> torch.Tensor:
        return torch.as_tensor(self.physics.free_dofs, device=self.device)

    def f_eff(self) -> torch.Tensor:
        """(N, n_free) effective forces ``f_f - K_fc y_c`` (one K1
        launch)."""
        f_full = self.physics.effective_force(self.alpha, self.bc_values)
        return f_full[:, self._free()]

    def batch_last_coefficients(self, dtype=None) -> torch.Tensor:
        """The N fields' stencil coefficients in K1's layout (7, Ny, Nx,
        N), contiguous."""
        alpha = self.alpha if dtype is None else self.alpha.to(dtype)
        return self.physics.op.coefficients(alpha).permute(1, 2, 3, 0) \
            .contiguous()

    def apply_Kff_columns(self, coefs: torch.Tensor,
                          V_cols: torch.Tensor) -> torch.Tensor:
        """``K_ff(x_n) v`` for every column: coefs from
        :meth:`batch_last_coefficients`, V_cols (m, N, n_free) -> (m, N,
        n_free), one K1 launch per column over the N fields."""
        grid = self.physics.grid
        Ny, Nx = grid.ny + 1, grid.nx + 1
        m, free = V_cols.shape[0], self._free()
        # one scatter and one gather for all columns; column j of v is a
        # contiguous (Ny, Nx, N) grid
        v = torch.zeros((m, grid.n_nodes, self.N), dtype=V_cols.dtype,
                        device=V_cols.device)
        v[:, free] = V_cols.transpose(1, 2)
        Kv = torch.stack([apply_batch_last(coefs, v[j].view(Ny, Nx, self.N))
                          for j in range(m)])
        return Kv.view(m, grid.n_nodes, self.N)[:, free].transpose(1, 2)

    def apply_Kff(self, V_free: torch.Tensor) -> torch.Tensor:
        """Batched ``K_ff(x_n) V_n``: V_free (N, n_free, m) -> (N, n_free,
        m)."""
        coefs = self.batch_last_coefficients(V_free.dtype)
        return self.apply_Kff_columns(coefs, V_free.permute(2, 0, 1)) \
            .permute(1, 2, 0)

    def construct_querry_weak_galerkin(self, V_free: torch.Tensor):
        """(Gamma (N, m, n_free) = V^T K_ff via symmetry, alpha (N, m) =
        V^T f_eff)."""
        coefs = self.batch_last_coefficients(V_free.dtype)
        KV = self.apply_Kff_columns(coefs, V_free.permute(2, 0, 1))
        Gamma = KV.permute(1, 0, 2).contiguous()
        alpha = torch.einsum("ndm,nd->nm", V_free, self.f_eff())
        return Gamma, alpha


# ---------------------------------------------------------------------------
# Test-function samplers
# ---------------------------------------------------------------------------

class BaseSampler:
    """m test functions per query point; ``is_constant`` controls resampling
    and ``precision_mask < 0`` marks infinite-precision constraints."""

    m: int
    is_constant: bool

    def precision_mask(self) -> np.ndarray:
        raise NotImplementedError

    def sample(self, qpe: QuerryPointEnsemble, generator):
        """-> (Gamma (N, m, d), alpha (N, m))"""
        raise NotImplementedError

    @property
    def fixed_precision(self) -> bool:
        return bool(np.all(self.precision_mask() < 0))


@dataclasses.dataclass
class CoarseGrainedResidualSampler(BaseSampler):
    """Constant V = W: the coarse-grained Galerkin residual."""

    W: np.ndarray  # (n_free, d_rom)

    @property
    def m(self) -> int:
        return self.W.shape[1]

    is_constant = True

    def precision_mask(self):
        return -np.ones(self.m)

    def sample(self, qpe, generator):
        W = torch.as_tensor(self.W, dtype=qpe.X_DG.dtype, device=qpe.device)
        return qpe.construct_querry_weak_galerkin(
            W.expand((qpe.N,) + W.shape))


@dataclasses.dataclass
class GaussianSketchingSampler(BaseSampler):
    """iid standard-normal test vectors."""

    N_aux: int

    @property
    def m(self) -> int:
        return self.N_aux

    is_constant = False

    def precision_mask(self):
        return -np.ones(self.m)

    def sample(self, qpe, generator):
        V = sketch_normals((qpe.N, qpe.dim_out, self.N_aux), generator,
                           qpe.X_DG.dtype, qpe.device)
        return qpe.construct_querry_weak_galerkin(V)


@dataclasses.dataclass
class RadialBasisFunctionSampler(BaseSampler):
    """Random-centre RBFs ``exp(-|s - r0|^2 / l^2)`` at the free node
    coordinates, the centres uniform over their bounding box."""

    l: float
    N_aux: int
    coords: np.ndarray  # (n_free, 2) free-dof coordinates

    @property
    def m(self) -> int:
        return self.N_aux

    is_constant = False

    def precision_mask(self):
        return -np.ones(self.m)

    def sample_V(self, generator, N: int, dtype, device) -> torch.Tensor:
        coords = torch.as_tensor(np.asarray(self.coords), dtype=dtype,
                                 device=device)
        lo, hi = coords.min(dim=0).values, coords.max(dim=0).values
        r0 = lo + (hi - lo) * rbf_uniforms((N, self.N_aux, 1, 2), generator,
                                           dtype, device)
        d2 = ((coords[None, None, :, :] - r0) ** 2).sum(-1)  # (N, m, n_free)
        V = torch.exp(-d2 / (self.l ** 2))
        return V.transpose(-1, -2)  # (N, n_free, m)

    def sample(self, qpe, generator):
        V = self.sample_V(generator, qpe.N, qpe.X_DG.dtype, qpe.device)
        return qpe.construct_querry_weak_galerkin(V)


@dataclasses.dataclass
class FluxConstrainSampler(BaseSampler):
    """Flux-continuity constraints; constant per sample, learnable
    precision (mask +1)."""

    operator: FluxConstraintOperator
    physics: LinearEllipticPhysics

    @property
    def m(self) -> int:
        return self.operator.n_constraints

    is_constant = True

    def precision_mask(self):
        return np.ones(self.m)

    def sample(self, qpe, generator):
        prof = self.physics.profile
        return self.operator.assemble_reduced(
            qpe.alpha, qpe.bc_values, prof.free_dofs, prof.constrained_dofs)


@dataclasses.dataclass
class ConcatenatedSamplers(BaseSampler):
    """Several samplers stacked; each draws from the one generator in
    turn."""

    samplers: Sequence[BaseSampler]

    @property
    def m(self) -> int:
        return sum(s.m for s in self.samplers)

    @property
    def is_constant(self) -> bool:
        return all(s.is_constant for s in self.samplers)

    def precision_mask(self):
        return np.concatenate([s.precision_mask() for s in self.samplers])

    def sample(self, qpe, generator):
        parts = [s.sample(qpe, generator) for s in self.samplers]
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1))


# ---------------------------------------------------------------------------
# Linear-Gaussian conditioning (the VO update)
# ---------------------------------------------------------------------------

def condition_ensemble(Gamma, alpha, G, PREC, vo_variances, eps=0.0):
    """Exact linear-Gaussian conditioning of every sample: prior y ~ N(g,
    diag(1/prec)), observation ``Gamma y = alpha + e`` with e ~ N(0,
    diag(vo_variances)).  Gamma (N, m, d), alpha (N, m), G/PREC (N, d),
    vo_variances (m,) -> posterior (mean, vars), each (N, d).

    The Schur matrix ``Lam = Gamma cov Gamma^T + diag(vo_var)`` is
    Jacobi-equilibrated before the Cholesky (unit diagonal) and ``eps`` is
    a relative diagonal jitter in that scaled system.  A sample whose
    Cholesky fails gets non-finite moments, as the JAX package's does."""
    eps = torch.as_tensor(eps, dtype=Gamma.dtype, device=Gamma.device)
    m = Gamma.shape[-2]
    cov = 1.0 / PREC
    A = Gamma * cov[:, None, :]                      # (N, m, d)
    Lam = A @ Gamma.transpose(-1, -2)
    Lam = Lam + torch.diag(vo_variances.to(Gamma.dtype))
    d = torch.sqrt(torch.diagonal(Lam, dim1=-2, dim2=-1))
    d = torch.where(d > 0, d, torch.ones_like(d))
    Lam_s = Lam / d[:, :, None] / d[:, None, :]
    Lam_s = Lam_s + eps * torch.eye(m, dtype=Lam.dtype, device=Lam.device)
    L, info = torch.linalg.cholesky_ex(Lam_s)
    L = torch.where((info != 0)[:, None, None],
                    torch.full_like(L, float("nan")), L)
    resid = ((Gamma @ G[..., None])[..., 0] - alpha) / d
    solvec = torch.cholesky_solve(resid[..., None], L)[..., 0] / d
    mean = G - cov * (Gamma.transpose(-1, -2) @ solvec[..., None])[..., 0]
    AL = torch.linalg.solve_triangular(L, A / d[..., None], upper=False)
    post_sub = torch.sum(AL * AL, dim=-2)
    # clamp here: f32 cancellation with near-exact constraints can leave
    # cov - post_sub slightly negative (NaN propagates, as in the JAX max)
    vars_ = torch.maximum(cov - post_sub, cov.new_tensor(1e-12))
    return mean, vars_


def gamma_precision_beta(Gamma, alpha, mean, vars_, weights=None):
    """Gamma-hyperprior posterior rate over the constraint-noise variances:
    beta_j = 0.5 sum_n [(Gamma_n mu_n - alpha_n)_j^2 + (Gamma_n^2 vars_n)_j].
    ``weights`` (N,): optional 0/1 mask that keeps failure-containment
    stand-ins out of the sum."""
    resid = torch.einsum("nmd,nd->nm", Gamma, mean) - alpha
    spread = torch.einsum("nmd,nd->nm", Gamma ** 2, vars_)
    per_sample = resid ** 2 + spread
    if weights is not None:
        per_sample = per_sample * weights[:, None]
    return 0.5 * torch.sum(per_sample, dim=0)


class _RowsOfEnsemble:
    """The ensembles' sharded layout (see the module docstring).
    ``split``: this process's rows of the N samples (a
    ``parallel.layout.RowSplit``; None unsharded), ``_layout`` the
    training layout that gathers them."""

    split = None
    _layout = None
    _qpe_local = None
    _MOMENTS = ("_mean", "_vars")

    def shard(self, layout) -> None:
        """Hold this process's rows of ``layout`` (a
        ``parallel.layout.TrainLayout``; None: all rows): the moments are
        cut from the whole ones (gathered first if already sharded)."""
        whole = self.moments()
        self._layout = layout
        self.split = None if layout is None else layout.rows(self.N)
        self._qpe_local = None
        self.load_moments(whole)

    def _rows(self, x):
        """This process's rows of ``x``, a tensor of all N samples."""
        return x if self.split is None or x is None else self.split.take(x)

    def _whole(self, x):
        """All N rows of ``x``, a tensor of this process's rows."""
        if self.split is None or x is None:
            return x
        if x.dtype == torch.bool:  # gathered as bytes
            return self._layout.gather(x.to(torch.uint8)).bool()
        return self._layout.gather(x)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes holding the other rows."""
        if self.split is None or self.split.group is None:
            return x
        return all_reduce_sum(x.contiguous(), self.split.group)

    @property
    def qpe_local(self) -> "QuerryPointEnsemble":
        """The query points of this process's rows."""
        if self.split is None:
            return self.qpe
        if self._qpe_local is None:
            self._qpe_local = QuerryPointEnsemble(
                self.qpe.physics, self._rows(self.qpe.X_DG),
                self._rows(self.qpe.bc_values))
        return self._qpe_local

    def moments(self) -> dict:
        """The state a checkpoint keeps, whole (gathered when sharded;
        the gathers are collectives: every process calls this)."""
        out = {k.lstrip("_"): self._whole(getattr(self, k))
               for k in self._MOMENTS}
        out.update(self._whole_state())
        return out

    def _whole_state(self) -> dict:
        return {}

    def load_moments(self, state: dict) -> None:
        """Set the state :meth:`moments` returned, cut to this process's
        rows, on the ensemble's device."""
        for k in self._MOMENTS:
            v = state.get(k.lstrip("_"))
            if v is not None:
                v = self._rows(v.to(self.device))
                v = v if v.dtype == torch.bool else v.to(self.dtype)
            setattr(self, k, v)
        self._load_whole_state(state)

    def _load_whole_state(self, state: dict) -> None:
        pass


class VirtualObservablesEnsemble(_RowsOfEnsemble):
    """Constraint-based VO ensemble with Gamma-hyperprior precision
    learning."""

    _MOMENTS = ("_mean", "_vars", "_fallback_mask")

    ALPHA_0 = 1e-6
    BETA_0 = 1e-6

    def __init__(self, qpe: QuerryPointEnsemble, sampler: BaseSampler,
                 dtype=None, prior_precision_factor: float = 1.0):
        self.qpe = qpe
        self.sampler = sampler
        self.dtype = dtype or qpe.X_DG.dtype
        self.device = qpe.device
        # a factor < 1 inflates the prior variance before conditioning
        # (prior tempering, beyond the reference)
        self.prior_precision_factor = float(prior_precision_factor)
        self._Gamma = None
        self._alpha = None
        self._mean = None
        self._vars = None
        # samples whose stored moments are failure-containment stand-ins
        # (excluded from the Gamma precision update until they recover)
        self._fallback_mask = None

        self.m = sampler.m
        self.N = qpe.N
        mask = sampler.precision_mask() < 0
        self._fixed_precision = bool(mask.all())
        self.infinite_precision_mask = torch.as_tensor(mask,
                                                       device=self.device)
        self._prec_alpha = 0.5 * self.N + self.ALPHA_0
        self._prec_beta = torch.ones(self.m, dtype=self.dtype,
                                     device=self.device)
        self.vo_variances = self._mean_vo_variances()
        self.resample(torch.Generator(self.device).manual_seed(0),
                      force=True)

    # ------------------------------------------------------------ state
    @property
    def dim_out(self) -> int:
        return self.qpe.dim_out

    @property
    def mean(self) -> torch.Tensor:
        if self._mean is None:
            raise RuntimeError("VO not yet updated")
        return self._mean

    @property
    def vars(self) -> torch.Tensor:
        if self._vars is None:
            raise RuntimeError("VO not yet updated")
        return self._vars

    @property
    def logsigma(self) -> torch.Tensor:
        return 0.5 * torch.log(self.vars)

    @property
    def Gamma(self) -> torch.Tensor:
        return self._Gamma

    @property
    def alpha(self) -> torch.Tensor:
        return self._alpha

    @property
    def fixed_precision(self) -> bool:
        return self._fixed_precision

    def _mean_vo_variances(self) -> torch.Tensor:
        """E[var] under the Gamma posterior, zero where the precision is
        infinite."""
        mean_vars = self._prec_beta / (self._prec_alpha + 1.0)
        return torch.where(self.infinite_precision_mask,
                           torch.zeros_like(mean_vars), mean_vars)

    def _whole_state(self) -> dict:
        return {"prec_alpha": self._prec_alpha, "prec_beta": self._prec_beta,
                "vo_variances": self.vo_variances}

    def _load_whole_state(self, state: dict) -> None:
        if "prec_beta" in state:
            self._prec_alpha = float(state["prec_alpha"])
            self._prec_beta = state["prec_beta"].to(self.device, self.dtype)
            self.vo_variances = state["vo_variances"].to(self.device,
                                                         self.dtype)

    # ---------------------------------------------------------- updates
    def resample(self, generator: torch.Generator, force: bool = False):
        """Redraw the non-constant test functions from ``generator`` (on
        the ensemble's device) and reassemble Gamma and alpha, for all N
        samples (sharded too)."""
        if self.sampler.is_constant and not force and self._Gamma is not None:
            return
        Gamma, alpha = self.sampler.sample(self.qpe, generator)
        self._Gamma = Gamma.to(self.dtype)
        self._alpha = alpha.to(self.dtype)

    def update_vo_precision(self, iteration: int, writer=None):
        """The Gamma-hyperprior update from the previous conditioned state;
        a no-op before the first conditioning.  Sharded, the sums over
        the samples run over every process's rows."""
        if self.fixed_precision or self._mean is None:
            return
        fb = self._fallback_mask
        Gamma, alpha = self._rows(self._Gamma), self._rows(self._alpha)
        n_clean = self.N
        if fb is not None:
            n_clean = int(self._sum((~fb).sum()))
        if n_clean == 0:
            # no clean sample: keep the previous beta rather than collapse
            # vo_variances to ~BETA_0/ALPHA_0 from an empty sum
            return
        if n_clean < self.N:
            # contained-failure stand-ins would inflate beta ensemble-wide
            w = (~fb).to(self._mean.dtype)
            beta = gamma_precision_beta(Gamma, alpha, self._mean,
                                        self._vars, w)
        else:
            beta = gamma_precision_beta(Gamma, alpha, self._mean,
                                        self._vars)
        self._prec_alpha = 0.5 * n_clean + self.ALPHA_0
        self._prec_beta = self._sum(beta) + self.BETA_0
        self.vo_variances = self._mean_vo_variances()
        if writer is not None:
            writer.add_scalar("Monitor/Mean_VO_variances",
                              float(torch.mean(self.vo_variances)),
                              global_step=iteration)

    def update(self, G, PREC, iteration: int, writer=None):
        """Condition on the constraints given the model's predictive
        moments G, PREC (N, d; sharded: this process's rows)."""
        self.update_vo_precision(iteration, writer)
        # relative jitter on the equilibrated Schur system
        eps = 1e-12 if self.dtype == torch.float64 else 1e-6
        vo_var = self.vo_variances
        G = G.to(self.dtype)
        PREC = PREC.to(self.dtype)
        if self.prior_precision_factor != 1.0:
            PREC = PREC * self.prior_precision_factor
        mean, vars_ = condition_ensemble(self._rows(self._Gamma),
                                         self._rows(self._alpha), G, PREC,
                                         vo_var, eps)
        # failure containment: a per-sample breakdown (non-finite output or
        # a non-finite model prior) must not poison the ensemble through
        # the next precision update; fall back for the failed samples
        bad = ~(torch.isfinite(mean).all(dim=1)
                & torch.isfinite(vars_).all(dim=1))
        # the one host sync of a refresh: the failures over all processes
        n_bad = int(self._sum(bad.sum()))
        if n_bad:
            bad_in = ~(torch.isfinite(G).all(dim=1)
                       & torch.isfinite(PREC).all(dim=1))
            warnings.warn(
                f"VO conditioning produced non-finite moments for {n_bad}/"
                f"{self.N} samples at iteration {iteration} "
                f"({int(self._sum(bad_in.sum()))} had a non-finite model "
                "prior); falling back to the prior/previous moments for "
                "those samples (set GPIPDE_VO_DUMP=<path> to capture the "
                "inputs)")
            # process 0's setting decides for every process, which all
            # take part in the gathers
            dump = os.environ.get("GPIPDE_VO_DUMP") \
                if self._layout is None or self._layout.lead else None
            if int(self._sum(torch.tensor(int(bool(dump)),
                                          device=G.device))):
                whole = [self._whole(x) for x in (G, PREC, bad)]
                if dump:
                    np.savez(dump, Gamma=self._Gamma.cpu().numpy(),
                             alpha=self._alpha.cpu().numpy(),
                             G=whole[0].cpu().numpy(),
                             PREC=whole[1].cpu().numpy(),
                             vo_var=vo_var.cpu().numpy(),
                             bad=whole[2].cpu().numpy(),
                             iteration=iteration)
            # best finite stand-in per sample: the prior moments, unless
            # the prior itself is non-finite and previous moments exist
            fb_mean, fb_vars = G, 1.0 / PREC
            if self._mean is not None:
                fb_mean = torch.where(bad_in[:, None], self._mean, fb_mean)
                fb_vars = torch.where(bad_in[:, None], self._vars, fb_vars)
            mean = torch.where(bad[:, None], fb_mean, mean)
            vars_ = torch.where(bad[:, None], fb_vars, vars_)
            # stored moments must be finite: zero mean with a huge variance
            # (+-inf -> 0, not the dtype's max, whose square overflows)
            mean = torch.nan_to_num(mean, nan=0.0, posinf=0.0, neginf=0.0)
            vars_ = torch.where(torch.isfinite(vars_), vars_,
                                vars_.new_tensor(1e6))
        if writer is not None and n_bad:
            writer.add_scalar("Monitor/VO_conditioning_failures", n_bad,
                              global_step=iteration)
        self._fallback_mask = bad if n_bad else None
        self._mean = mean
        self._vars = torch.maximum(vars_, vars_.new_tensor(1e-12))


# ---------------------------------------------------------------------------
# Energy-based virtual observables
# ---------------------------------------------------------------------------

class TemperatureSchedule:
    def get_temperature(self, iteration: int) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class LinearTemperatureSchedule(TemperatureSchedule):
    T_init: float
    T_final: float
    num_steps: int

    def __post_init__(self):
        assert self.num_steps > 1 and self.T_final < self.T_init

    def get_temperature(self, iteration):
        # holds T_final once exhausted (the reference overshoots below it)
        frac = min(iteration, self.num_steps - 1) / (self.num_steps - 1)
        return self.T_init + frac * (self.T_final - self.T_init)


@dataclasses.dataclass
class ExponentialTemperatureSchedule(TemperatureSchedule):
    T_init: float
    T_final: float
    num_steps: int

    def __post_init__(self):
        assert self.num_steps > 1 and self.T_final < self.T_init
        self._lmbda = -np.log(self.T_final / self.T_init)

    def get_temperature(self, iteration):
        t = min(iteration, self.num_steps - 1) / (self.num_steps - 1)
        return self.T_init * np.exp(-self._lmbda * t)


class EnergyVirtualObservablesEnsemble(_RowsOfEnsemble):
    """Energy-minimisation VOs: minimise ``(1/T)(0.5 y^T K y - f^T y) +
    0.5 ||y - g||^2_prec`` by randomized-subspace iteration, batched over
    the ensemble; each iteration applies ``K_ff`` to its s test columns and
    to the iterate (s + 1 K1 launches over the N fields, sharded over this
    process's rows)."""

    def __init__(self, qpe: QuerryPointEnsemble,
                 num_iterations_per_update: int,
                 sampler: RadialBasisFunctionSampler, dtype=None):
        self.qpe = qpe
        self.num_iterations_per_update = num_iterations_per_update
        self.sampler = sampler
        self.dtype = dtype or qpe.X_DG.dtype
        self._temperature = 1.0
        self._forced_temperature = None
        self._schedule: Optional[TemperatureSchedule] = None
        self._mean = torch.zeros((qpe.N, qpe.dim_out), dtype=self.dtype,
                                 device=qpe.device)
        self._vars = None
        self._K_diag = qpe.physics.op.diagonal(qpe.alpha)[
            :, qpe._free()].to(self.dtype)

    # ---------------------------------------------------------- plumbing
    @property
    def N(self):
        return self.qpe.N

    @property
    def device(self) -> torch.device:
        return self.qpe.device

    @property
    def dim_out(self):
        return self.qpe.dim_out

    @property
    def temperature(self) -> float:
        return (self._forced_temperature
                if self._forced_temperature is not None
                else self._temperature)

    def force_temperature(self, value):
        self._forced_temperature = value

    def set_temperature(self, value):
        if not value > 0:  # inv_T = 1/T is used directly
            raise ValueError(f"temperature must be > 0, got {value}")
        self._temperature = value

    def set_temperature_schedule(self, type: str, T_init, T_final, num_steps):
        cls = {"linear": LinearTemperatureSchedule,
               "exponential": ExponentialTemperatureSchedule}[type.lower()]
        self._schedule = cls(T_init, T_final, num_steps)

    def set_linear_temperature_schedule(self, T_init=1.0, T_final=1e-4,
                                        num_steps=None):
        if num_steps is None:
            raise ValueError
        self._schedule = LinearTemperatureSchedule(T_init, T_final, num_steps)

    @property
    def mean(self):
        return self._mean

    @property
    def vars(self):
        if self._vars is None:
            raise RuntimeError("VO not yet updated")
        return self._vars

    @property
    def logsigma(self):
        return 0.5 * torch.log(self.vars)

    def resample(self, generator, force: bool = False):
        pass  # the test functions are drawn inside update

    def update_vo_precision(self, iteration, writer=None):
        """Temperature annealing; with no schedule a temperature set by
        ``set_temperature`` (or the default 1) is kept."""
        if self._forced_temperature is not None:
            return
        if self._schedule is not None:
            self._temperature = self._schedule.get_temperature(iteration)
        if writer is not None:
            writer.add_scalar("Monitor/Temperature", self._temperature,
                              global_step=iteration)

    def update(self, G, PREC, iteration: int, writer=None):
        """``num_iterations_per_update`` subspace steps from the current
        mean, their test functions drawn from a generator seeded with 101 +
        iteration (the reference folds its fixed key 101 with the
        iteration).  G, PREC (N, d; sharded: this process's rows)."""
        self.update_vo_precision(iteration, writer)
        dt = self.dtype
        inv_T = torch.tensor(1.0 / self.temperature, dtype=dt,
                             device=self.qpe.device)
        G = G.to(dt)
        PREC = PREC.to(dt)
        self._vars = 1.0 / (PREC + inv_T * self._rows(self._K_diag))
        generator = torch.Generator(self.qpe.device).manual_seed(
            101 + iteration)
        self._mean = self._iterate(self._mean, G, PREC, inv_T, generator)

    def _iterate(self, mean, G, PREC, inv_T, generator):
        qpe, dt = self.qpe_local, self.dtype
        b = inv_T * qpe.f_eff().to(dt) + PREC * G
        coefs = qpe.batch_last_coefficients(dt)

        def apply_A(V_cols):
            """(diag(prec) + inv_T K_ff) v for columns (k, N, d)."""
            return PREC * V_cols + inv_T * qpe.apply_Kff_columns(coefs,
                                                                 V_cols)

        for _ in range(self.num_iterations_per_update):
            # the test functions of all N samples (the generator advances
            # alike on every process), this process's rows kept
            V = self._rows(self.sampler.sample_V(generator, self.N, dt,
                                                 qpe.device))
            AV = apply_A(V.permute(2, 0, 1)).permute(1, 2, 0)  # (N, d, s)
            Vt = V.transpose(-1, -2)
            Msub = Vt @ AV
            r = (Vt @ (apply_A(mean[None])[0] - b)[..., None])
            sol, info = torch.linalg.solve_ex(Msub, r)
            new = mean - (V @ sol)[..., 0]
            # containment: a singular subspace system would poison the
            # carried mean for good -- keep that sample's previous iterate
            ok = (info == 0) & torch.isfinite(new).all(dim=1)
            mean = torch.where(ok[:, None], new, mean)
        return mean


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

def build_virtual_observables_ensemble(vo_spec: dict, dataset_vo, physics,
                                       dtype=None):
    """The VO ensemble of a reference-style spec dict:
    {'type': 'constrain'|'energy', 'CGR': bool, 'flux': bool,
     'N_gaussian': int, 'N_rbf': int, 'l_rbf': float, and for 'energy':
     'energy_num_iterations_per_update', 'T_init', 'T_final',
     'T_iterations'}.  ``dataset_vo.get`` gives 'X_DG' (a tensor on the
    physics' device, taken in ``dtype``) and 'BCE'."""
    if not isinstance(vo_spec, dict) or "type" not in vo_spec:
        raise ValueError("vo_spec dict with a 'type' key is required")

    fom = physics["fom"]
    X_DG = torch.as_tensor(dataset_vo.get("X_DG"), device=fom.device)
    if dtype is not None:
        X_DG = X_DG.to(dtype)
    bce = dataset_vo.get("BCE")
    bc_values = torch.as_tensor(bce.constrained_values("fom"),
                                dtype=X_DG.dtype, device=fom.device)
    qpe = QuerryPointEnsemble(physics=fom, X_DG=X_DG, bc_values=bc_values)

    coords = fom.grid.node_coords[fom.profile.free_dofs]
    kind = vo_spec["type"].lower()
    if kind == "energy":
        sampler = RadialBasisFunctionSampler(
            l=vo_spec["l_rbf"], N_aux=vo_spec["N_rbf"], coords=coords)
        vo = EnergyVirtualObservablesEnsemble(
            qpe, vo_spec["energy_num_iterations_per_update"], sampler,
            dtype=dtype)
        vo.set_temperature_schedule(
            "exponential", T_init=vo_spec["T_init"],
            T_final=vo_spec["T_final"], num_steps=vo_spec["T_iterations"])
        return vo

    if kind == "constrain":
        samplers = []
        if vo_spec.get("CGR"):
            samplers.append(CoarseGrainedResidualSampler(W=physics["W"]))
        if vo_spec.get("flux"):
            op = FluxConstraintOperator(coarse=physics["rom"].grid,
                                        fine=fom.grid)
            samplers.append(FluxConstrainSampler(operator=op, physics=fom))
        if vo_spec.get("N_gaussian", 0) > 0:
            samplers.append(GaussianSketchingSampler(vo_spec["N_gaussian"]))
        if vo_spec.get("N_rbf", 0) > 0:
            samplers.append(RadialBasisFunctionSampler(
                l=vo_spec["l_rbf"], N_aux=vo_spec["N_rbf"], coords=coords))
        if not samplers:
            raise ValueError("vo_spec selected no samplers")
        sampler = samplers[0] if len(samplers) == 1 \
            else ConcatenatedSamplers(samplers)
        return VirtualObservablesEnsemble(
            qpe, sampler, dtype=dtype,
            prior_precision_factor=vo_spec.get("prior_precision_factor", 1.0))

    raise ValueError(f"Type: {vo_spec['type']} not known as specification.")


def vo_spec_preset(kind: str = "energy", *, T_iterations: int = None,
                   **overrides) -> dict:
    """The JAX package's ``vo_spec`` presets.  ``kind='energy'`` (the
    default) needs ``T_iterations``, the planned number of SVI iterations
    the annealing schedule spans; ``kind='constrain'`` is the reference's
    linear-Gaussian arm.  Keyword ``overrides`` are merged on top."""
    kind = kind.lower()
    if kind == "energy":
        if T_iterations is None and "T_iterations" not in overrides:
            raise ValueError(
                "vo_spec_preset('energy') needs T_iterations: the annealing "
                "schedule must span the planned SVI iteration count")
        spec = {"type": "energy", "l_rbf": 0.2, "N_rbf": 32,
                "energy_num_iterations_per_update": 10,
                "T_init": 1.0, "T_final": 1e-6,
                "T_iterations": T_iterations}
    elif kind == "constrain":
        spec = {"type": "constrain", "CGR": True, "flux": True,
                "N_gaussian": 8, "N_rbf": 8, "l_rbf": 0.2}
    else:
        raise ValueError(f"unknown vo preset kind {kind!r} "
                         "(expected 'energy' or 'constrain')")
    spec.update(overrides)
    return spec
