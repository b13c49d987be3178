"""The port's files: dataset files (in the JAX package's format, moved
both ways between the packages), the metrics writer's JSONL file (and the
trainer's, through ``folder=``), and the surrogate bundle on disk (one
``torch.export`` program per bucket).

Ports of ``tests/test_training.py`` ``test_dataloader_roundtrip`` and
``test_metrics_writer``, and of ``tests/test_serving.py``
``test_export_matches_direct_call`` and ``test_bundle_roundtrip_on_disk``.
The port is compared with itself, so exactly: a loaded bundle predicts
bit for bit what the in-memory bundle predicts (the JAX test: 1e-6);
dataset files carry equal fields and the same hash across the packages.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from generative_physics_informed_pde_tpu.data import DataLoader as JDataLoader
from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch import serving
from generative_physics_informed_pde_tpu_torch.data import DataLoader
from generative_physics_informed_pde_tpu_torch.factories import (
    highres32, highres128)
from generative_physics_informed_pde_tpu_torch.serving import SurrogateBundle
from generative_physics_informed_pde_tpu_torch.training import (
    CreateTrainer, MetricsWriter, TrainerParameters)


def _fields(n, seed=0, size=32):
    rf = fem.GaussianRandomField.from_image(size, size, 0.4, 0.8, 0.15)
    return rf.sample(torch.Generator().manual_seed(seed), batch_size=n,
                     dtype=torch.float64, device="cpu").numpy()


# ------------------------------------------------------------- datasets
def test_dataloader_roundtrip(tmp_path):
    dl = DataLoader(_fields(6))
    path = str(tmp_path / "fields.npz")
    dl.save(path)
    dl2 = DataLoader.from_file(path)
    np.testing.assert_array_equal(dl2.X, dl.X)
    assert dl2.hash == dl.hash
    with pytest.raises(ValueError, match=".npz"):
        dl.save(str(tmp_path / "fields.dat"))  # np.savez would add .npz
    assert not (tmp_path / "fields.dat.npz").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_files_move_between_the_packages(tmp_path, writer):
    X = _fields(5, seed=1)
    path = str(tmp_path / "fields.npz")
    if writer == "jax":
        src = JDataLoader(X)
        src.save(path)
        got = DataLoader.from_file(path)
    else:
        src = DataLoader(X)
        src.save(path)
        got = JDataLoader.from_file(path)
    np.testing.assert_array_equal(got.X, X)
    assert got.hash == src.hash == DataLoader(X).hash


def test_reset_partition():
    dl = DataLoader(_fields(8, seed=2))
    dl.ascending_partition({"a": 3, "b": 2})
    dl.randomized_partition({"c": 4}, identifier="other",
                            rng=np.random.default_rng(0))
    view = dl.construct_dataset_dictionary(identifier="default",
                                           dtype=torch.float64,
                                           device="cpu")["a"]
    assert view.get("X").shape[0] == 3
    dl.reset_partition("default")
    assert list(dl._permutation) == ["other"] and view._cache == {}
    dl.ascending_partition({"a": 5})  # the identifier is free again
    dl.reset_partition()
    assert dl._permutation == dl._assigned_chunks == {}
    with pytest.raises(RuntimeError, match="no partitions"):
        dl.construct_dataset_dictionary(dtype=torch.float64, device="cpu")


# -------------------------------------------------------------- metrics
def _lines(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_metrics_writer(tmp_path):
    w = MetricsWriter(str(tmp_path), comment="run", logging_interval=2,
                      mirror_tensorboard=False)
    w.add_scalar("a/b", 1.0, 0)
    w.add_scalar("a/b", 2.0, 1)   # throttled out
    w.add_scalar("a/b", 3.0, 2)
    w.add_scalars({"elbo": torch.tensor(-4.5), "x/y": 0.25}, 4,
                  prefix="objective/")
    assert [v for _, v in w.scalars["a/b"]] == [1.0, 3.0]
    assert w.path == str(tmp_path / "metrics_run.jsonl")
    # line-buffered: every line is in the file before a flush
    assert len(_lines(w.path)) == 4
    w.add_hparams({"dummy": 0}, {"r2_y": 0.5})
    w.flush()
    w.close()
    lines = _lines(w.path)
    got = [(d["tag"], d["step"], d["value"]) for d in lines[:-1]]
    assert got == [(tag, s, v) for tag, pairs in w.scalars.items()
                   for s, v in pairs]
    assert lines[-1] == {"hparams": {"dummy": 0},
                         "metrics": {"r2_y": 0.5}}
    assert MetricsWriter().path is None


def test_trainer_writes_its_metrics_under_folder(tmp_path):
    """``params.folder`` reaches the trainer's writer; the file's lines
    are the in-memory scalars, and ``finalize`` flushes and closes it."""
    X = _fields(20, seed=3)
    p = TrainerParameters()
    p.identifier = "highres32"
    p.folder = str(tmp_path / "logs")
    p.comment = "unit"
    p.trainer.update(lr_init=1e-2, N_monitor_interval=2, N_PE_updates=1,
                     N_PE_updates_final=1, N_monte_carlo_analysis=4,
                     N_monte_carlo_analysis_final=4)
    p.data.update(N_u=8, N_s=8, N_u_max=8, N_s_max=8, N_val=4,
                  armortized_bs=4)
    dlu = DataLoader(X[12:])
    dlu.lock_physics_assembly()
    tr = CreateTrainer(p, DataLoader(X[:12]), dlu, device="cpu")
    tr.run(5, verbose=False)
    tr.finalize()
    path = tmp_path / "logs" / "metrics_unit.jsonl"
    assert tr.writer.path == str(path) and tr.writer._fh is None
    lines = _lines(path)
    # repr: a NaN scalar (JSON's NaN token) compares equal to itself
    got = sorted(repr((d["tag"], d["step"], d["value"])) for d in lines
                 if "tag" in d)
    want = sorted(repr((tag, s, v)) for tag, pairs in
                  tr.writer.scalars.items() for s, v in pairs)
    assert got == want
    assert {"validation/r2_y", "Monitoring/lr", "objective/elbo"} \
        <= {d["tag"] for d in lines if "tag" in d}
    assert lines[-1]["metrics"] == tr.results()


# -------------------------------------------------------------- serving
def _model(preset, **margs):
    return preset(**margs).setup(
        device="cpu", generator=torch.Generator().manual_seed(0))[2]


def _request(n, img, dim_F, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.4, 0.8, (n, img, img)),
            rng.uniform(-0.5, 0.5, (n, dim_F)))


def test_export_matches_direct_call():
    """A request of exactly a bucket's size: the bundle's frozen copy
    gives what the module gives."""
    dm = _model(highres32)
    bundle = SurrogateBundle.build(dm, (32, 32), 25, buckets=(4, 8),
                                   device="cpu")
    x, F = _request(4, 32, 25, 1)
    xt, Ft = (torch.as_tensor(a, dtype=torch.float32) for a in (x, F))
    assert torch.equal(bundle.predict(x, F), dm.eval()(xt, Ft))


# the highres32 model, and a 32^2 highres128 stand-in with the codec's
# remat and a bf16 codec (the options the port's presets carry that touch
# the served forward)
BUNDLE_MODELS = {
    "highres32": (highres32, {}, 25),
    "highres128-remat-bf16": (highres128, dict(
        nx_rom=4, ny_rom=4, num_refines=3, remat_codec=True,
        compute_dtype="bfloat16"), 25),
}


@pytest.mark.parametrize("name", list(BUNDLE_MODELS))
def test_bundle_roundtrip_on_disk(tmp_path, name):
    preset, margs, dim_F = BUNDLE_MODELS[name]
    dm = _model(preset, **margs)
    bundle = SurrogateBundle.build(dm, (32, 32), dim_F, buckets=(4, 8),
                                   device="cpu")
    path = str(tmp_path / "surrogate.zip")
    assert bundle.save(path) == path
    loaded = SurrogateBundle.load(path, device="cpu")
    assert loaded.buckets == bundle.buckets == (4, 8)
    assert loaded.image_shape == (32, 32) and loaded.dim_F == dim_F
    assert loaded.dtype == torch.float32 and loaded.device.type == "cpu"
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        assert sorted(zf.namelist()) == ["bucket_4.cpu.pt2",
                                         "bucket_8.cpu.pt2",
                                         "manifest.json"]
    assert manifest["device"] == "cpu" and manifest["platforms"] == ["cpu"] \
        and manifest["torch"] == torch.__version__
    for n, seed in ((3, 4), (8, 5), (13, 6)):  # pad, exact, stream
        x, F = _request(n, 32, dim_F, seed)
        got, want = loaded.predict(x, F), bundle.predict(x, F)
        assert got.shape == (n, want.shape[1])
        assert torch.equal(got, want), n
    # a loaded bundle saves its programs again
    again = SurrogateBundle.load(loaded.save(str(tmp_path / "b.zip")),
                                 device="cpu")
    x, F = _request(5, 32, dim_F, 7)
    assert torch.equal(again.predict(x, F), bundle.predict(x, F))


def _rewrite_manifest(src, dst, **changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "manifest.json":
                data = json.dumps({**json.loads(data), **changes})
            zout.writestr(item, data)
    return dst


def test_bundle_load_refuses_another_torch_or_device(tmp_path):
    bundle = SurrogateBundle.build(_model(highres32), (32, 32), 25,
                                   buckets=(4,), device="cpu")
    path = bundle.save(str(tmp_path / "s.zip"))
    other = _rewrite_manifest(path, str(tmp_path / "t.zip"),
                              torch="1.13.1")
    with pytest.raises(ValueError, match="saved by torch 1.13.1"):
        SurrogateBundle.load(other, device="cpu")
    card = _rewrite_manifest(path, str(tmp_path / "c.zip"), device="cuda",
                             platforms=["cuda"])
    with pytest.raises(ValueError, match="load it with device='cuda'"):
        SurrogateBundle.load(card, device="cpu")
    (tmp_path / "n.zip").write_bytes(b"")
    with zipfile.ZipFile(tmp_path / "n.zip", "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a surrogate bundle"):
        SurrogateBundle.load(str(tmp_path / "n.zip"), device="cpu")
    assert serving._torch_minor("2.11.0+cu128") == "2.11"


def test_trainer_export_surrogate_writes_the_bundle(tmp_path):
    X = _fields(20, seed=8)
    p = TrainerParameters()
    p.identifier = "highres32"
    p.trainer.update(lr_init=1e-2, N_monitor_interval=0, N_PE_updates=0)
    p.data.update(N_u=8, N_s=8, N_u_max=8, N_s_max=8, N_val=4,
                  armortized_bs=4)
    dlu = DataLoader(X[12:])
    dlu.lock_physics_assembly()
    tr = CreateTrainer(p, DataLoader(X[:12]), dlu, device="cpu")
    tr.run(2, verbose=False)
    path = str(tmp_path / "surrogate.zip")
    bundle = tr.export_surrogate(path, buckets=(8,))
    loaded = SurrogateBundle.load(path, device="cpu")
    x, F = _request(6, 32, 25, 9)
    assert torch.equal(loaded.predict(x, F), bundle.predict(x, F))
