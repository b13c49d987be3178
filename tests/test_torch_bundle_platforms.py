"""The surrogate bundle's platforms: ``SurrogateBundle.build(platforms=)``,
the ``platforms`` property, ``save`` / ``load`` with one program per
bucket and platform, and the bundles of the first format, which hold one
platform's programs as ``bucket_{b}.pt2``.

On the CPU the bundle is exported for ``("cpu",)``; a ``("cuda", "cpu")``
bundle, served on both, is checked on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 17.  The port is compared with itself, so
exactly: a loaded program predicts bit for bit what the frozen module
predicts.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from generative_physics_informed_pde_tpu_torch import serving
from generative_physics_informed_pde_tpu_torch.factories import highres32
from generative_physics_informed_pde_tpu_torch.serving import SurrogateBundle

DIM_F = 25


@pytest.fixture(scope="module")
def model():
    return highres32().setup(
        device="cpu", generator=torch.Generator().manual_seed(0))[2]


def _request(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.4, 0.8, (n, 32, 32)),
            rng.uniform(-0.5, 0.5, (n, DIM_F)))


def _rewrite(src, dst, manifest=None, rename=None):
    """Copy a bundle zip, changing manifest keys and entry names."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "manifest.json" and manifest is not None:
                data = json.dumps(manifest(json.loads(data)))
            zout.writestr((rename or {}).get(item, item), data)
    return dst


def test_build_for_the_cpu_platform_saves_and_loads_it(model, tmp_path):
    bundle = SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4, 8),
                                   device="cpu", platforms=("cpu",))
    assert bundle.platforms == ("cpu",)
    assert SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4,),
                                 device="cpu").platforms == ("cpu",)
    path = bundle.save(str(tmp_path / "s.zip"))
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        names = sorted(zf.namelist())
    assert names == ["bucket_4.cpu.pt2", "bucket_8.cpu.pt2",
                     "manifest.json"]
    assert manifest["platforms"] == ["cpu"] \
        and manifest["format"] == serving.BUNDLE_FORMAT
    loaded = SurrogateBundle.load(path, device="cpu")
    assert loaded.platforms == ("cpu",) and loaded.buckets == (4, 8)
    for n, seed in ((3, 1), (8, 2), (11, 3)):  # pad, exact, stream
        x, F = _request(n, seed)
        assert torch.equal(loaded.predict(x, F), bundle.predict(x, F))


def test_platforms_are_checked_and_nothing_falls_back(model):
    for bad in ((), ["cuda"]):
        with pytest.raises(ValueError, match="platforms"):
            SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4,),
                                  device="cpu", platforms=bad)
    if not torch.cuda.is_available():
        # a program for the card needs the card: no CPU stand-in
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4,),
                                  device="cpu", platforms=("cpu", "cuda"))
    bundle = SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4,),
                                   device="cpu")
    with pytest.raises(ValueError, match=r"platforms are \('cpu',\)"):
        bundle._program(4, "cuda")


def test_load_on_a_platform_the_bundle_lacks_names_its_platforms(
        model, tmp_path):
    bundle = SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4,),
                                   device="cpu")
    path = bundle.save(str(tmp_path / "s.zip"))
    card = _rewrite(path, str(tmp_path / "c.zip"),
                    manifest=lambda m: {**m, "device": "cuda",
                                        "platforms": ["cuda", "meta"]},
                    rename={"bucket_4.cpu.pt2": "bucket_4.cuda.pt2"})
    with pytest.raises(ValueError, match=r"platforms \('cuda', 'meta'\)"):
        SurrogateBundle.load(card, device="cpu")


def test_a_loaded_bundle_saves_its_other_platforms_as_they_were(
        model, tmp_path):
    bundle = SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4,),
                                   device="cpu")
    path = bundle.save(str(tmp_path / "s.zip"))
    # a second platform's program, as another host would have exported it
    two = str(tmp_path / "two.zip")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(two, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "manifest.json":
                m = json.loads(data)
                data = json.dumps({**m, "platforms": ["cpu", "other"]})
            zout.writestr(item, data)
        zout.writestr("bucket_4.other.pt2", b"opaque program bytes")
    loaded = SurrogateBundle.load(two, device="cpu")
    assert loaded.platforms == ("cpu", "other")
    again = loaded.save(str(tmp_path / "again.zip"))
    with zipfile.ZipFile(again) as zf:
        assert zf.read("bucket_4.other.pt2") == b"opaque program bytes"
        assert json.loads(zf.read("manifest.json"))["platforms"] == [
            "cpu", "other"]
    x, F = _request(3, 5)
    assert torch.equal(SurrogateBundle.load(again, device="cpu").predict(
        x, F), bundle.predict(x, F))


def test_a_bundle_of_the_first_format_still_loads(model, tmp_path):
    """The format of the bundles written before platforms: no platforms
    key, the device's programs as ``bucket_{b}.pt2``."""
    bundle = SurrogateBundle.build(model, (32, 32), DIM_F, buckets=(4, 8),
                                   device="cpu")
    path = bundle.save(str(tmp_path / "s.zip"))

    def v1(m):
        m = {k: v for k, v in m.items() if k != "platforms"}
        return {**m, "format": serving.BUNDLE_FORMAT_V1}

    old = _rewrite(path, str(tmp_path / "v1.zip"), manifest=v1,
                   rename={f"bucket_{b}.cpu.pt2": f"bucket_{b}.pt2"
                           for b in (4, 8)})
    with zipfile.ZipFile(old) as zf:
        assert "platforms" not in json.loads(zf.read("manifest.json"))
    loaded = SurrogateBundle.load(old, device="cpu")
    assert loaded.platforms == ("cpu",) and loaded.buckets == (4, 8)
    x, F = _request(6, 4)
    assert torch.equal(loaded.predict(x, F), bundle.predict(x, F))
    # saved again, it is a bundle of the current format
    with zipfile.ZipFile(loaded.save(str(tmp_path / "v2.zip"))) as zf:
        assert sorted(zf.namelist()) == ["bucket_4.cpu.pt2",
                                         "bucket_8.cpu.pt2", "manifest.json"]
    card = _rewrite(old, str(tmp_path / "v1c.zip"),
                    manifest=lambda m: {**m, "device": "cuda"})
    with pytest.raises(ValueError, match=r"platforms \('cuda',\)"):
        SurrogateBundle.load(card, device="cpu")
