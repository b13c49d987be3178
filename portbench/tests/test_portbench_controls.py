"""What decides ``correct`` can fail: each cell's control (the plain
reference in the program's place, a precision lower than the
configuration states) fails a limit, and a run whose timed path is broken
underneath (a step that leaves its state unchanged, half the batch left
out, an answer altered where it is produced) comes out not correct.  The
CPU cases run at small sizes; the TF32 control needs a card."""

from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny


def _fails(numbers, traffic):
    return any(v > traffic["limits"][k] for k, v in numbers.items())


@pytest.mark.parametrize("cell", ["c5-sweep", "c3-label"])
def test_control_fails_a_limit(cell):
    driver, ctx, out = tiny.execute(cell)
    assert out["correct"]
    assert _fails(driver.control(ctx), ctx.traffic)


@pytest.mark.cuda
def test_tf32_control_fails_a_limit_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on a card only")
    driver, ctx, out = tiny.execute("c3-train", device="cuda")
    assert out["correct"], out["checks"]
    assert _fails(driver.control(ctx), ctx.traffic)


# ------------------------------------------------------------------ faults
def _pcg_returns_its_start(monkeypatch):
    from generative_physics_informed_pde_tpu_torch.fem import batched_solver

    def unchanged(matvec, b, mask, precond, tol, maxiter):
        return torch.zeros_like(b), 0

    monkeypatch.setattr(batched_solver, "_batched_pcg", unchanged)


def _sweep_half_batch(monkeypatch):
    import torch_uncertainty_study as tus

    orig = tus.qoi_moments

    def half(q, C):
        q = q.reshape(C, -1)
        return orig(q[:, : q.shape[1] // 2].reshape(-1), C)

    monkeypatch.setattr(tus, "qoi_moments", half)


def _sweep_altered_answer(monkeypatch):
    import torch_uncertainty_study as tus

    orig = tus.centre_qoi

    def altered(phys, Y, bc):
        q = orig(phys, Y, bc).clone()
        q[3] += 0.01
        return q

    monkeypatch.setattr(tus, "centre_qoi", altered)


def _label_half_batch(monkeypatch):
    from generative_physics_informed_pde_tpu_torch.fem import physics

    orig = physics.LinearEllipticPhysics.solve_batched

    def half(self, alphas, bc_values):
        # every other system solved, each answer standing for two
        y = orig(self, alphas[::2], bc_values[::2])
        return y.repeat_interleave(2, dim=0)[: alphas.shape[0]]

    monkeypatch.setattr(physics.LinearEllipticPhysics, "solve_batched", half)


def _label_altered_answer(monkeypatch):
    from generative_physics_informed_pde_tpu_torch.fem import physics

    orig = physics.LinearEllipticPhysics.solve_batched

    def altered(self, alphas, bc_values):
        y = orig(self, alphas, bc_values).clone()
        y[1, 5] += 1e-3
        return y

    monkeypatch.setattr(physics.LinearEllipticPhysics, "solve_batched",
                        altered)


def _adam_leaves_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, c=None: None)


def _train_half_batch(monkeypatch):
    from generative_physics_informed_pde_tpu_torch.models import generative

    orig = generative.GenerativeModel.elbo_unsupervised_amortized

    def half(self, X_batch, *a, **kw):
        e, logs = orig(self, X_batch[: X_batch.shape[0] // 2], *a, **kw)
        return 2 * e, {k: 2 * v for k, v in logs.items()}

    monkeypatch.setattr(generative.GenerativeModel,
                        "elbo_unsupervised_amortized", half)


FAULTS = {
    ("c5-sweep", "state unchanged"): _pcg_returns_its_start,
    ("c5-sweep", "half the batch"): _sweep_half_batch,
    ("c5-sweep", "answer altered"): _sweep_altered_answer,
    ("c3-label", "state unchanged"): _pcg_returns_its_start,
    ("c3-label", "half the batch"): _label_half_batch,
    ("c3-label", "answer altered"): _label_altered_answer,
    ("c3-train", "state unchanged"): _adam_leaves_state,
    ("c3-train", "half the batch"): _train_half_batch,
    ("c3-train", "label altered"): _label_altered_answer,
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS), ids=lambda x: str(x))
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    import sys

    sys.path.insert(0, str(tiny.ROOT / "examples"))
    FAULTS[(cell, fault)](monkeypatch)
    _, _, out = tiny.execute(cell)
    assert not out["correct"], out["checks"]
