"""Carry the JAX model's Flax weights into the port's modules.

A Flax ``params`` / ``batch_stats`` tree (nested dicts whose leaves are
arrays; numpy or anything ``np.asarray`` reads) is walked path for path:
each dict key names a submodule of the same name in the port
(``Conv_0``, ``DenseBlock_1``, ``BatchNorm_0``, ...), and each leaf maps to
a tensor:

* Conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W)
* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in)
* ``bias`` -> ``bias``; BatchNorm ``scale`` -> ``weight``
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
* any other leaf (``logsigmas_X``, ``logsigmas_y``, a posterior's
  ``mean`` / ``logsigma``, a linear or MLP codec's ``logsigma``) -> the
  parameter of that name.

A conv kernel of a codec built with ``codec_pad_cin`` holds more input
rows than the port's unpadded conv: the rows past the conv's real input
channels only ever see the zero padding, so they are dropped and the
loaded module computes the same function.  The MLPs (``Dense_0``,
``Dense_1``, ...) and the linear codecs map layer for layer, and so does a
whole ``DenseED`` (``Conv_0``, ``DenseBlock_i``, ``TransitionDown_i``,
``TransitionUp_i``, ``LastDecoding_0``) with its ``batch_stats``.

A whole ``GenerativeModel`` whose posteriors were created for the same
datasets (``init_params``) loads from the JAX model's ``params`` (``f``,
``encoder``, ``gp``, ``g``, and ``q_z`` / ``q_X`` with their
'supervised', 'unsupervised' and virtual-observable 'vo' entries) and
``batch_stats`` (``f``, ``encoder``) with :func:`load_flax_variables`, so
both packages start training from one state; so does the prediction
ensemble's ``q``.

Every parameter and BatchNorm statistic of the target module must be
covered, and every shape must match; anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaf_target(module, name: str, value: np.ndarray, stats: bool):
    if name == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    if name == "scale":
        return "weight", value
    if stats and name in _STAT_NAMES:
        return _STAT_NAMES[name], value
    return name, value


def _load(module, tree, prefix: str, loaded: set, stats: bool):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            if not hasattr(module, key):
                raise KeyError(f"no submodule {path} in "
                               f"{type(module).__name__}")
            _load(getattr(module, key), val, path + ".", loaded, stats)
            continue
        attr, arr = _leaf_target(module, key, np.asarray(val), stats)
        target = getattr(module, attr, None)
        if not isinstance(target, torch.Tensor):
            raise KeyError(f"no tensor for {path} ({attr})")
        if key == "kernel" and arr.ndim == 4 and target.ndim == 4 \
                and arr.shape[1] > target.shape[1]:
            arr = arr[:, :target.shape[1]]  # zero-fed padded input rows
        if tuple(target.shape) != arr.shape:
            raise ValueError(f"{path}: Flax shape {arr.shape} vs port "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.tensor(arr))
        loaded.add(prefix + attr)


def load_flax_variables(module: torch.nn.Module, params: dict,
                        batch_stats: dict | None = None) -> torch.nn.Module:
    """Copy Flax ``params`` (and ``batch_stats``) into ``module`` in
    place; returns the module."""
    loaded: set = set()
    _load(module, params, "", loaded, stats=False)
    if batch_stats:
        _load(module, batch_stats, "", loaded, stats=True)
    wanted = {n for n, _ in module.named_parameters()}
    wanted |= {n for n, _ in module.named_buffers()
               if n.endswith(("running_mean", "running_var"))}
    missing = sorted(wanted - loaded)
    if missing:
        raise KeyError(f"Flax tree leaves no value for {missing}")
    return module


def discriminative_from_flax(discriminative, params: dict,
                             batch_stats: dict) -> torch.nn.Module:
    """Load the JAX model's ``encoder``, ``gp`` and ``g`` entries of
    ``params`` / ``batch_stats`` into a port ``DiscriminativeModel``."""
    model = discriminative.model
    if model.encoder is not None:
        load_flax_variables(model.encoder, params["encoder"],
                            batch_stats.get("encoder", {}))
    load_flax_variables(model.gp, params["gp"])
    load_flax_variables(model.g, params["g"])
    return discriminative

