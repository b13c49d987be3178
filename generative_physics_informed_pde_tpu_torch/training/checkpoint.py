"""Training-state checkpoint / resume on ``torch.save``.

Port of ``generative_physics_informed_pde_tpu/training/checkpoint.py``.
The JAX package writes its ``TrainState`` pytree with orbax; here one file
holds plain containers of tensors, numbers and strings, read back with
``torch.load(weights_only=True)`` (no pickled code).  What a trainer
writes is assembled by ``Trainer.save_checkpoint``; a sharded trainer
gathers its per-datapoint blocks first and process 0 writes the unsharded
layout, which ``Trainer.restore_checkpoint`` cuts again for its own mesh
(``parallel.shard_train_state``).
"""

from __future__ import annotations

import os

import torch


def save_train_state(path: str, state: dict) -> str:
    """Write ``state`` (tensors, numbers, strings, lists and dicts of
    them) to ``path``; returns the absolute path."""
    path = os.path.abspath(path)
    torch.save(state, path)
    return path


def restore_train_state(path: str, map_location="cpu") -> dict:
    """Read a state written by :func:`save_train_state`; tensors land on
    ``map_location`` (default the host, which every machine has)."""
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def _codec_modules(model) -> dict:
    return {k: m for k, m in (("f", model.f), ("encoder", model.encoder))
            if m is not None}


def save_encoder_decoder(path: str, model) -> str:
    """Snapshot of the decoder ``f`` and the encoder alone (their
    parameters and BatchNorm statistics)."""
    return save_train_state(path, {k: m.state_dict() for k, m in
                                   _codec_modules(model).items()})


def restore_encoder_decoder(path: str, model, map_location="cpu"):
    """Load a :func:`save_encoder_decoder` snapshot into ``model``'s
    decoder and encoder, whatever device either was written or lives on;
    returns ``model``."""
    state = restore_train_state(path, map_location=map_location)
    for k, m in _codec_modules(model).items():
        if k in state:
            m.load_state_dict(state[k])
    return model
