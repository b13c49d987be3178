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
per bucket and platform; ``load`` serves those programs.  A program
carries its constants on the device it was exported on, so a bundle
exports one program per bucket for each torch device type in its
``platforms`` (``("cuda", "cpu")`` serves on a card and on a CPU host, as
the JAX package's ``("tpu", "cpu")`` does), and is loaded by one torch
major.minor (the program format is not stable across them).  A bundle of
the first format (one platform, ``bucket_{b}.pt2``) still loads.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import zipfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.device import resolve_device

DEFAULT_BUCKETS = (8, 64, 512)
BUNDLE_FORMAT = "gpipde-torch-surrogate-bundle-v2"
# one platform, programs at bucket_{b}.pt2
BUNDLE_FORMAT_V1 = "gpipde-torch-surrogate-bundle-v1"


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


def _platforms(platforms, device: torch.device) -> Tuple[str, ...]:
    """The torch device types a bundle exports for: ``device``'s alone for
    None, else the given ones, which must include it."""
    if platforms is None:
        return (device.type,)
    out = tuple(dict.fromkeys(str(p) for p in platforms))
    if not out:
        raise ValueError("platforms must be None or non-empty")
    if device.type not in out:
        raise ValueError(f"platforms {out} must include the bundle's device "
                         f"type {device.type!r}")
    return out


@dataclasses.dataclass
class SurrogateBundle:
    """A set of surrogate callables, one per static batch bucket, serving
    on ``device``; ``frozen`` holds the frozen module of each platform the
    bundle exports for.  A loaded bundle holds the programs it serves, of
    its device's platform."""

    buckets: Tuple[int, ...]
    image_shape: Tuple[int, ...]
    dim_F: int
    dtype: torch.dtype
    device: torch.device
    calls: Dict[int, Callable]
    programs: Dict[int, "torch.export.ExportedProgram"] = dataclasses.field(
        default_factory=dict)
    frozen: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    platform_names: Tuple[str, ...] = ()
    # a loaded bundle's programs of its other platforms, as saved
    saved: Dict[str, bytes] = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, discriminative, image_shape: Sequence[int], dim_F: int, *,
              buckets: Sequence[int] = DEFAULT_BUCKETS,
              dtype=torch.float32, device="cuda",
              platforms: Optional[Sequence[str]] = None,
              use_encoder: bool = True) -> "SurrogateBundle":
        """Freeze the surrogate on ``device``, which serves ``predict``.
        ``platforms``: the torch device types (``"cuda"``, ``"cpu"``) the
        bundle exports a program for at every bucket; None is ``device``'s
        alone.  A frozen copy of the module is made on each, so exporting
        for ``"cuda"`` needs a card."""
        device = resolve_device(device)
        if not buckets:
            raise ValueError("buckets must be non-empty")
        names = _platforms(platforms, device)
        frozen = {p: surrogate_fn(discriminative, dtype=dtype,
                                  device=device if p == device.type else p,
                                  use_encoder=use_encoder) for p in names}
        fn = frozen[device.type]
        bs = tuple(sorted(set(int(b) for b in buckets)))
        return cls(buckets=bs,
                   image_shape=tuple(int(s) for s in image_shape),
                   dim_F=int(dim_F), dtype=dtype, device=device,
                   calls={b: fn for b in bs}, frozen=frozen,
                   platform_names=names)

    @property
    def platforms(self) -> Tuple[str, ...]:
        """The torch device types the bundle has programs for."""
        return self.platform_names or (self.device.type,)

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
    def _program(self, bucket: int, platform: str):
        """The ``torch.export`` program of ``bucket`` for ``platform``,
        exported at the bucket's static batch from the module frozen on
        that platform; a loaded bundle returns the program it loaded."""
        if platform == self.device.type and bucket in self.programs:
            return self.programs[bucket]
        if platform not in self.frozen:
            raise ValueError(f"the bundle has no module for {platform!r}; "
                             f"its platforms are {self.platforms}")
        dev = self.device if platform == self.device.type else \
            torch.device(platform)
        x = torch.zeros((bucket,) + self.image_shape, dtype=self.dtype,
                        device=dev)
        F = torch.zeros((bucket, self.dim_F), dtype=self.dtype, device=dev)
        program = torch.export.export(self.frozen[platform], (x, F))
        if platform == self.device.type:
            self.programs[bucket] = program
        return program

    def save(self, path: str) -> str:
        """Write the bundle as one zip: ``manifest.json`` and a
        ``torch.export`` program per bucket and platform,
        ``bucket_{b}.{platform}.pt2``."""
        manifest = {"buckets": list(self.buckets),
                    "image_shape": list(self.image_shape),
                    "dim_F": self.dim_F,
                    "dtype": str(self.dtype).removeprefix("torch."),
                    "device": self.device.type,
                    "platforms": list(self.platforms),
                    "torch": torch.__version__, "format": BUNDLE_FORMAT}
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("manifest.json", json.dumps(manifest))
            for p in self.platforms:
                for b in self.buckets:
                    name = f"bucket_{b}.{p}.pt2"
                    if name in self.saved:
                        zf.writestr(name, self.saved[name])
                        continue
                    buf = io.BytesIO()
                    torch.export.save(self._program(b, p), buf)
                    zf.writestr(name, buf.getvalue())
        return path

    @classmethod
    def load(cls, path: str, device="cuda") -> "SurrogateBundle":
        """A bundle serving the programs of ``device``'s type from a
        :meth:`save` zip, which must have them; the torch that saved it
        must have this torch's major.minor."""
        device = resolve_device(device)
        with zipfile.ZipFile(path, "r") as zf:
            manifest = json.loads(zf.read("manifest.json"))
            fmt = manifest.get("format")
            if fmt not in (BUNDLE_FORMAT, BUNDLE_FORMAT_V1):
                raise ValueError(f"not a surrogate bundle: {path}")
            if _torch_minor(manifest["torch"]) != _torch_minor(
                    torch.__version__):
                raise ValueError(
                    f"{path} was saved by torch {manifest['torch']}; this "
                    f"is torch {torch.__version__}: export the bundle again "
                    "with this torch")
            platforms = tuple(manifest.get("platforms",
                                           [manifest["device"]]))
            if device.type not in platforms:
                raise ValueError(
                    f"{path} holds programs for the platforms {platforms}, "
                    f"whose constants live there, and none for "
                    f"{device.type!r}: load it with "
                    f"device={platforms[0]!r}"
                    f"{' or another of them' if len(platforms) > 1 else ''}"
                    f", or export it again with {device.type!r} among its "
                    "platforms")
            suffix = "" if fmt == BUNDLE_FORMAT_V1 else f".{device.type}"
            programs = {int(b): torch.export.load(
                io.BytesIO(zf.read(f"bucket_{b}{suffix}.pt2")))
                for b in manifest["buckets"]}
            saved = {f"bucket_{b}.{p}.pt2": zf.read(f"bucket_{b}.{p}.pt2")
                     for p in platforms if p != device.type
                     for b in manifest["buckets"]}
        bs = tuple(sorted(programs))
        return cls(buckets=bs, image_shape=tuple(manifest["image_shape"]),
                   dim_F=int(manifest["dim_F"]),
                   dtype=getattr(torch, manifest["dtype"]), device=device,
                   calls={b: programs[b].module() for b in bs},
                   programs=programs, platform_names=platforms,
                   saved=saved)
