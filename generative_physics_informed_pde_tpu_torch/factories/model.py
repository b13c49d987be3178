"""Named model presets wiring physics and networks into models.

Port of ``ModelFactory`` and its ``highres``, ``highres32`` and
``highres128`` presets from
``generative_physics_informed_pde_tpu/factories/model.py``: the fom/rom
physics, the decoder, the encoder, gp and g wired into a
``GenerativeModel``, with the JAX factory's knobs: the codec's
``compute_dtype``, ``unsup_compute_dtype`` ('auto': bf16 from 128^2
decodes on), ``fuse_decodes``, ``remat_codec``, ``codec_pad_cin`` and the
decoder overrides ``dec_growth_rate`` / ``dec_init_features`` /
``dec_blocks`` (None: the preset's).  Weights are random, drawn from an
explicit ``torch.Generator``; trained weights come in through
``convert.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..fem.physics import make_fom_rom_pair
from ..models.codec import BatchNorm
from ..models.components import (EffectivePropertyMap,
                                 ReducedOrderModelOperator)
from ..models.decoder import CNNDecoder
from ..models.encoder import CNNEncoder
from ..models.generative import DiscriminativeModel, GenerativeModel
from ..utils.device import resolve_device


def fetch_dtype(dtype: str) -> torch.dtype:
    d = dtype.lower()
    if d == "float32":
        return torch.float32
    if d in ("float64", "double"):
        return torch.float64
    if d in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"dtype option not recognized: {dtype}")


# Flax's ``lecun_normal``: a standard normal truncated to [-2, 2], scaled so
# that the variance is 1/fan_in (the truncated normal's std is 0.8796...)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with Flax's default distributions: conv and dense
    kernels ``lecun_normal`` (truncated normal, variance 1/fan_in), biases
    zero, BatchNorm scale one and bias zero with running stats (0, 1);
    other parameters keep their constructor values (the logsigmas start at
    one)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape, dtype=torch.float64)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            m.weight.copy_(w / (_TRUNC_STD * math.sqrt(fan_in)))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    return module


class ModelFactory:
    """Base factory: a parameter dict with ``set`` overrides; a preset
    names its codec widths in ``_decoder`` / ``_encoder`` (or computes
    them from the target size in ``_codec``)."""

    _decoder: dict
    _encoder: dict

    def __init__(self, **kwargs):
        self.params = {
            "independent_X": True,
            "ptype": None,
            "dim_latent": None,
            "dtype": None,
            "nx_rom": None,
            "ny_rom": None,
            "eff_property_map_hidden_layers": None,
            "num_refines": None,
            "use_encoder": True,
            "binary_field": False,
            "droprate": 0.0,
            "homoscedastic": False,
            # the codec's conv compute dtype (None: full precision)
            "compute_dtype": None,
            "fuse_decodes": False,
            "remat_codec": False,
            # the unsupervised terms' codec dtype; 'auto' is bf16 from
            # 128^2 decodes on, as the JAX package measured it
            "unsup_compute_dtype": "auto",
            "codec_pad_cin": 0,
            "dec_growth_rate": None,
            "dec_init_features": None,
            "dec_blocks": None,
        }

    @property
    def dtype(self) -> torch.dtype:
        return fetch_dtype(self.params["dtype"])

    def set(self, *args):
        """Single-key or dict override."""
        if len(args) == 1 and isinstance(args[0], dict):
            for key, val in args[0].items():
                if key not in self.params:
                    raise KeyError(key)
                self.params[key] = val
        elif len(args) == 2 and isinstance(args[0], str):
            if args[0] not in self.params:
                raise KeyError(args[0])
            self.params[args[0]] = args[1]
        else:
            raise ValueError

    def _gp(self, key):
        value = self.params[key]
        if value is None:
            raise ValueError(f"parameter {key} is unset")
        return value

    def _dec(self, key, default):
        """A decoder override, None meaning the preset's value: an
        explicit None check, so that a falsy override (0, ()) reaches the
        constructor and fails there."""
        v = self.params[key]
        return default if v is None else v

    def _codec(self, target: int):
        """(decoder, encoder) widths of the preset at ``target``."""
        return dict(self._decoder), dict(self._encoder)

    def _compute_dtype(self):
        cd = self.params["compute_dtype"]
        return None if cd is None else fetch_dtype(cd)

    def _setup_physics(self, device):
        return make_fom_rom_pair(self._gp("ptype"), self._gp("nx_rom"),
                                 self._gp("ny_rom"), self._gp("num_refines"),
                                 device=device)

    def _closure(self, physics, encoder, decoder, device, generator):
        g = ReducedOrderModelOperator.from_physics(physics)
        gp = EffectivePropertyMap(
            latent_dim=decoder.dim_latent,
            dim_effective_property=g.dim_effective_property,
            num_hidden_layers=self._gp("eff_property_map_hidden_layers"),
            independent_X=self.params["independent_X"])
        ucd = self.params["unsup_compute_dtype"]
        if ucd == "auto":
            ucd = "bfloat16" if decoder.target_img_size >= 128 else None
        model = GenerativeModel(
            g=g, gp=gp, encoder=encoder, f=decoder,
            independent_X=self.params["independent_X"],
            binary_field=self.params["binary_field"],
            fuse_decodes=self.params["fuse_decodes"],
            remat_codec=self.params["remat_codec"],
            unsup_compute_dtype=None if ucd is None else fetch_dtype(ucd))
        init_weights_(model, generator)
        model.to(device=device, dtype=self.dtype).eval()
        return physics, model, DiscriminativeModel(model), encoder, self.dtype

    def setup(self, device="cuda", generator: Optional[torch.Generator] = None):
        """-> (physics, model, discriminative, encoder, dtype) on
        ``device``, weights drawn from ``generator`` (default seed 0)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        physics = self._setup_physics(device)
        target = self._gp("nx_rom") * 2 ** self._gp("num_refines")
        dec, enc = self._codec(target)
        dec.update(
            init_features=self._dec("dec_init_features",
                                    dec["init_features"]),
            blocks=tuple(self._dec("dec_blocks", dec["blocks"])),
            growth_rate=self._dec("dec_growth_rate", dec["growth_rate"]))
        codec = dict(drop_rate=self.params["droprate"],
                     pad_cin=self.params["codec_pad_cin"],
                     compute_dtype=self._compute_dtype())
        decoder = CNNDecoder(
            target_img_size=target, dim_latent=self._gp("dim_latent"),
            upsample="nearest", binary=self.params["binary_field"],
            homoscedastic=self.params["homoscedastic"], **dec, **codec)
        encoder = CNNEncoder(imsize=target,
                             latent_dim=self._gp("dim_latent"), **enc,
                             **codec)
        if not self.params["use_encoder"]:
            encoder = None
        return self._closure(physics, encoder, decoder, device, generator)

    def physics(self, device="cuda") -> dict:
        """The preset's fom/rom physics dict and interpolator W on
        ``device``: ``setup()[0]`` (the JAX package's ``physics``
        property), without building the networks."""
        return self._setup_physics(resolve_device(device))

    @classmethod
    def FromIdentifier(cls, identifier: str, *args, **kwargs):
        try:
            factory_class = _REGISTRY[identifier]
        except KeyError:
            raise KeyError(f"unknown model factory identifier "
                           f"{identifier!r}")
        return factory_class(*args, **kwargs)

    from_identifier = FromIdentifier

    @property
    def identifier(self) -> str:
        return type(self).__name__


class highres(ModelFactory):
    """64x64 FOM / 8x8 ROM on 'ND', channel dropout 0.2 -- the recipe of
    ``bench.py``."""

    _decoder = dict(latent_img_size=8, latent_img_features=1,
                    init_features=6, blocks=(1, 2, 1), growth_rate=4)
    _encoder = dict(blocks=(1, 2, 1), growth_rate=4, init_features=6)

    def __init__(self, **kwargs):
        super().__init__()
        self.params.update(
            ptype="ND", dim_latent=64, binary_field=False, dtype="float32",
            nx_rom=8, ny_rom=8, eff_property_map_hidden_layers=0,
            num_refines=3, droprate=0.2)
        self.set(kwargs)


class highres32(ModelFactory):
    """32x32 FOM / 4x4 ROM on 'NDP' -- the example-notebook recipe."""

    _decoder = dict(latent_img_size=8, latent_img_features=1,
                    init_features=4, blocks=(1, 1), growth_rate=4)
    _encoder = dict(blocks=(1, 1), growth_rate=4, init_features=4)

    def __init__(self, **kwargs):
        super().__init__()
        self.params.update(
            ptype="NDP", dim_latent=16, dtype="float32", nx_rom=4, ny_rom=4,
            eff_property_map_hidden_layers=0, num_refines=3, droprate=0.0,
            homoscedastic=False)
        self.set(kwargs)


class highres128(ModelFactory):
    """128x128 FOM / 8x8 ROM refined 4 times on 'NDP' (BASELINE config
    3): latent 64, an 8x8x2 latent image and one decoder block per x2
    up-sampling, ``log2(target / 8)`` of them."""

    def __init__(self, **kwargs):
        super().__init__()
        self.params.update(
            ptype="NDP", dim_latent=64, binary_field=False, dtype="float32",
            nx_rom=8, ny_rom=8, eff_property_map_hidden_layers=0,
            num_refines=4, droprate=0.0, homoscedastic=False)
        self.set(kwargs)

    def _codec(self, target: int):
        n_up = int(math.log2(target // 8))
        blocks = tuple(self._dec("dec_blocks", (1, 2, 1, 1, 1, 1)[:n_up]))
        if len(blocks) != n_up:
            raise ValueError(f"dec_blocks {blocks} must have {n_up} "
                             f"entries for target {target}")
        return (dict(latent_img_size=8, latent_img_features=2,
                     init_features=16, blocks=blocks, growth_rate=8),
                dict(blocks=(1, 2, 1, 1, 1)[:max(2, n_up - 1)],
                     growth_rate=8, init_features=16))


_REGISTRY = {"highres": highres, "highres32": highres32,
             "highres128": highres128}
