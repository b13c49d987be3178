"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card the default raises instead of carrying on silently on the CPU: a CPU
run is only ever one the caller asked for with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device) -> a concrete ``torch.device``.

    A CUDA device without an index resolves to the current card, so that
    it compares equal to ``tensor.device``.  Raises RuntimeError when a
    CUDA device is asked for and none is available.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} needs a CUDA card, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise if tensor ``t`` is not on ``device``."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
