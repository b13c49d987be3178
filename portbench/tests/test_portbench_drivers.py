"""Each driver runs a small cell end to end on the CPU (the kernels' plain
versions) and reports what the benchmark reads; a card-only case runs the
same small cells on the card, through the kernels."""

from __future__ import annotations

import pytest

from portbench.tests import tiny


def _has_card():
    import torch

    return torch.cuda.is_available()


@pytest.fixture
def card():
    if not _has_card():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _expect(out, cell, trace):
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = list(out["checks"])
    assert names and all(c["value"] <= c["limit"]
                         for c in out["checks"].values())
    if not trace:
        assert "setup_s" in out["metrics"]
        assert len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", tiny.ONE_CARD)
def test_small_cell_on_the_cpu(cell):
    _, ctx, out = tiny.execute(cell)
    _expect(out, cell, trace=False)
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", tiny.ONE_CARD)
def test_small_traced_cell_on_the_cpu(cell):
    """A traced run reads the host trace; no device metric is written
    from a CPU run."""
    _, ctx, out = tiny.execute(cell, trace=True)
    _expect(out, cell, trace=True)
    for name in out["metrics"]:
        assert not name.startswith(("device_idle", "peak_gb", "k1_roofline",
                                    "conv_ms", "solve_elementwise",
                                    "train_mfu", "sweep_mfu"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.ONE_CARD)
def test_small_traced_cell_on_the_card(card, cell):
    _, ctx, out = tiny.execute(cell, trace=True, device=card)
    _expect(out, cell, trace=True)
    assert out["device"]["busy_s"] > 0
    assert out["breakdown"]["device_ops"]
