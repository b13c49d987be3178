"""Serving of the extracted discriminative surrogate with static batch
buckets.

Port of ``SurrogateBundle`` from
``generative_physics_informed_pde_tpu/serving.py``: the same buckets
(8, 64, 512), pad-to-bucket, streaming of larger requests through the
largest bucket and the same input validation.  A built bundle holds a
frozen copy of the eager module for every bucket.  ``save`` writes one zip:
``manifest.json`` (the JAX package's fields plus the device type and the
torch version) and one ``torch.export`` program per bucket, exported at
the bucket's static batch as the JAX package exports one StableHLO module
per bucket; ``load`` serves those programs.  A program carries its
constants on the device it was exported on, so a bundle is saved and
loaded on one device type, and by one torch major.minor (the program
format is not stable across them).
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import zipfile
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .utils.device import resolve_device

DEFAULT_BUCKETS = (8, 64, 512)
BUNDLE_FORMAT = "gpipde-torch-surrogate-bundle-v1"


class _Surrogate(torch.nn.Module):
    """``f(x, F) -> y`` over a frozen discriminative model: the module a
    bucket's program is exported from."""

    def __init__(self, discriminative, use_encoder: bool):
        super().__init__()
        self.discriminative = discriminative
        self.use_encoder = use_encoder

    def forward(self, x, F):
        return self.discriminative(x, F, use_encoder=self.use_encoder)


def surrogate_fn(discriminative, *, dtype=torch.float32, device="cuda",
                 use_encoder: bool = True) -> Callable:
    """Freeze a surrogate into a pure ``f(x, F) -> y``: a deep copy of the
    module in eval mode on ``device``, so later training of the original
    does not change what is served."""
    snap = copy.deepcopy(discriminative).to(
        device=resolve_device(device), dtype=dtype).eval()
    snap.requires_grad_(False)
    return _Surrogate(snap, use_encoder)


def _torch_minor(version: str) -> str:
    return ".".join(version.split("+")[0].split(".")[:2])


@dataclasses.dataclass
class SurrogateBundle:
    """A set of surrogate callables, one per static batch bucket; a loaded
    bundle also holds the programs it serves."""

    buckets: Tuple[int, ...]
    image_shape: Tuple[int, ...]
    dim_F: int
    dtype: torch.dtype
    device: torch.device
    calls: Dict[int, Callable]
    programs: Dict[int, "torch.export.ExportedProgram"] = dataclasses.field(
        default_factory=dict)

    @classmethod
    def build(cls, discriminative, image_shape: Sequence[int], dim_F: int, *,
              buckets: Sequence[int] = DEFAULT_BUCKETS,
              dtype=torch.float32, device="cuda",
              use_encoder: bool = True) -> "SurrogateBundle":
        device = resolve_device(device)
        if not buckets:
            raise ValueError("buckets must be non-empty")
        fn = surrogate_fn(discriminative, dtype=dtype, device=device,
                          use_encoder=use_encoder)
        bs = tuple(sorted(set(int(b) for b in buckets)))
        return cls(buckets=bs,
                   image_shape=tuple(int(s) for s in image_shape),
                   dim_F=int(dim_F), dtype=dtype, device=device,
                   calls={b: fn for b in bs})

    def predict(self, x, F) -> torch.Tensor:
        """Serve a request of any batch size: pad up to the smallest bucket
        that fits; stream requests beyond the largest bucket through it in
        chunks (the last one padded).  Returns exactly ``x.shape[0]``
        rows."""
        x, F = self._as_input(x), self._as_input(F)
        if x.dim() == 0 or F.dim() == 0:
            raise ValueError("x and F must be batched arrays, got a scalar")
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty request")
        if F.shape[0] != n:
            raise ValueError(f"x batch {n} != F batch {F.shape[0]}")
        if tuple(x.shape[1:]) != self.image_shape:
            raise ValueError(f"x image shape {tuple(x.shape[1:])} != "
                             f"exported {self.image_shape}")
        if tuple(F.shape[1:]) != (self.dim_F,):
            raise ValueError(f"F feature dim {tuple(F.shape[1:])} != "
                             f"({self.dim_F},)")
        cap = self.buckets[-1]
        if n <= cap:
            return self._call_padded(x, F, n)
        outs = []
        for i in range(0, n, cap):
            xs, fs = x[i:i + cap], F[i:i + cap]
            outs.append(self._call_padded(xs, fs, xs.shape[0]))
        return torch.cat(outs, dim=0)

    def _as_input(self, a) -> torch.Tensor:
        """Cast to the bundle's dtype and device; host arrays are copied
        (they may be read-only, which ``torch.as_tensor`` cannot alias)."""
        if isinstance(a, torch.Tensor):
            return a.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def _call_padded(self, x, F, n: int) -> torch.Tensor:
        bucket = next(b for b in self.buckets if b >= n)
        if n < bucket:
            pad = bucket - n
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            F = torch.cat([F, F.new_zeros((pad,) + tuple(F.shape[1:]))])
        return self.calls[bucket](x, F)[:n]

    # ------------------------------------------------------ persistence
    def _program(self, bucket: int):
        """The bucket's ``torch.export`` program, exported at its static
        batch on the bundle's device the first time it is asked for."""
        if bucket not in self.programs:
            x = torch.zeros((bucket,) + self.image_shape, dtype=self.dtype,
                            device=self.device)
            F = torch.zeros((bucket, self.dim_F), dtype=self.dtype,
                            device=self.device)
            self.programs[bucket] = torch.export.export(self.calls[bucket],
                                                        (x, F))
        return self.programs[bucket]

    def save(self, path: str) -> str:
        """Write the bundle as one zip: ``manifest.json`` and a
        ``torch.export`` program per bucket."""
        manifest = {"buckets": list(self.buckets),
                    "image_shape": list(self.image_shape),
                    "dim_F": self.dim_F,
                    "dtype": str(self.dtype).removeprefix("torch."),
                    "device": self.device.type, "torch": torch.__version__,
                    "format": BUNDLE_FORMAT}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("manifest.json", json.dumps(manifest))
            for b in self.buckets:
                buf = io.BytesIO()
                torch.export.save(self._program(b), buf)
                zf.writestr(f"bucket_{b}.pt2", buf.getvalue())
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "SurrogateBundle":
        """A bundle serving the programs of a :meth:`save` zip on
        ``device``, which must be of the device type it was saved on; the
        torch that saved it must have this torch's major.minor."""
        device = resolve_device(device)
        with zipfile.ZipFile(path, "r") as zf:
            manifest = json.loads(zf.read("manifest.json"))
            if manifest.get("format") != BUNDLE_FORMAT:
                raise ValueError(f"not a surrogate bundle: {path}")
            if _torch_minor(manifest["torch"]) != _torch_minor(
                    torch.__version__):
                raise ValueError(
                    f"{path} was saved by torch {manifest['torch']}; this "
                    f"is torch {torch.__version__}: export the bundle again "
                    "with this torch")
            if manifest["device"] != device.type:
                raise ValueError(
                    f"{path} was exported on {manifest['device']!r}, which "
                    f"its programs' constants live on; load it with "
                    f"device={manifest['device']!r}, or export it again on "
                    f"{device.type!r}")
            programs = {int(b): torch.export.load(
                io.BytesIO(zf.read(f"bucket_{b}.pt2")))
                for b in manifest["buckets"]}
        bs = tuple(sorted(programs))
        return cls(buckets=bs, image_shape=tuple(manifest["image_shape"]),
                   dim_F=int(manifest["dim_F"]),
                   dtype=getattr(torch, manifest["dtype"]), device=device,
                   calls={b: programs[b].module() for b in bs},
                   programs=programs)
