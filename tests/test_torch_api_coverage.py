"""The port covers the JAX package's public API, name by name and
keyword by keyword.

The JAX package is read with ``ast`` only (never imported): its
subpackages' ``__all__`` lists, the public top-level names of each of its
modules, and the public methods of its classes.  Each must have a
counterpart in the port's module of the same path, except the names of
``EXCEPTIONS`` (each with its reason) and the renames of ``RENAMED``.  The
methods the port added in its last API slice are named one by one too.
Every parameter of a public JAX function, method or ``__init__`` must be a
parameter of its counterpart's signature, except the pairs of
``KEYWORD_EXCEPTIONS`` (each with its reason).
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "generative_physics_informed_pde_tpu"
PORT = "generative_physics_informed_pde_tpu_torch"

# name (or Class.method) -> why the port has no counterpart
EXCEPTIONS = {
    "effective_platform": "JAX platform probing (utils/backend.py)",
    "choose_tile_rows": "the TPU kernel's row tiling",
    "LANES": "the TPU's 128-lane vector width",
    "TrainState": "the port's trainer keeps its state in modules and a "
                  "torch optimizer, not a functional pytree",
    # functional-state and JAX-transform hooks
    "Analysis.eval_all_x_fn": "builds the function the JAX package jits",
    "Analysis.eval_all_y_fn": "builds the function the JAX package jits",
    "PredictionEnsemble.init": "a functional (q, optimizer state) init; the "
                               "port's ensemble owns both",
    "ReducedOrderModelOperator.init_params": "a functional parameter tree; "
                                             "the port's module owns "
                                             "logsigmas_y",
    "CNNDecoder.setup": "Flax's module setup hook",
    "DiscriminativeModel.extract": "copies buffers of a donated TrainState",
    "DiscriminativeModel.extract_params": "copies buffers of a donated "
                                          "TrainState",
}
# why a JAX parameter has no counterpart in the port's signature
_STATE = ("functional state turned into module state: the port's modules "
          "and optimizers own it")
_KEY = "a JAX PRNG key turned into a torch.Generator argument"
_TPU = "a TPU-only knob (Pallas interpret mode, VMEM tiling, chunking)"
# "module.Qualname" of a JAX function or method -> {parameter: reason}
KEYWORD_EXCEPTIONS = {
    **{f"constraints.virtual_observables.{c}.sample": {"key": _KEY}
       for c in ("BaseSampler", "CoarseGrainedResidualSampler",
                 "GaussianSketchingSampler", "RadialBasisFunctionSampler",
                 "FluxConstrainSampler", "ConcatenatedSamplers")},
    "constraints.virtual_observables.RadialBasisFunctionSampler.sample_V":
        {"key": _KEY},
    **{f"constraints.virtual_observables.{c}.resample": {"key": _KEY}
       for c in ("VirtualObservablesEnsemble",
                 "EnergyVirtualObservablesEnsemble")},
    "data.sampling.BatchedOverSampler.batches": {"key": _KEY},
    "data.sampling.minibatch_indices": {"key": _KEY},
    "fem.batched_solver.make_batched_fom_solver": {
        "use_pallas": _TPU,
        "fused_rr": "the port's stop rule is the fused form, and the two "
                    "forms give the same results"},
    "fem.randomfield.GaussianRandomField.sample": {"key": _KEY},
    "fem.solvers.rom_solve": {"max_chunk": _TPU},
    "inference.analysis.Analysis.sample_predictive_y": {
        "params": _STATE, "key": _KEY},
    "inference.analysis.Analysis.sample_predictive_x": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY},
    "inference.analysis.Analysis.eval_all_y": {"params": _STATE,
                                               "key": _KEY},
    "inference.analysis.Analysis.eval_all": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY},
    "inference.analysis.Analysis.from_encoder": {"params": _STATE,
                                                 "batch_stats": _STATE},
    "inference.likelihoods.reparametrize": {"key": _KEY},
    "inference.prediction.PredictionEnsemble.elbo": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY},
    "inference.prediction.PredictionEnsemble.update": {
        "params": _STATE, "batch_stats": _STATE, "q": _STATE,
        "opt_state": _STATE, "key": _KEY},
    **{f"inference.variational.{f}": {"key": _KEY}
       for f in ("sample", "sample_component", "sample_all_components")},
    "models.calibration.optimize_effective_properties": {
        "g_params": _STATE},
    "models.components.propagate_gp_samples": {"key": _KEY},
    "models.components.ReducedOrderModelOperator.propagate_samples": {
        "params": _STATE, "key": _KEY},
    "models.generative.GenerativeModel.init_params": {
        "key": _KEY,
        "image_shape": "the port's networks take their shapes when they are "
                       "built; init_params makes only the per-datapoint "
                       "posteriors, sized by the datasets"},
    **{f"models.generative.GenerativeModel.{m}": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY,
        "module": _STATE} for m in ("apply_decoder", "apply_encoder")},
    "models.generative.GenerativeModel.apply_gp": {"params": _STATE},
    "models.generative.GenerativeModel.apply_g": {"params": _STATE},
    **{f"models.generative.GenerativeModel.{m}": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY,
        "decoded": "the port's fused= carries the fused decode's draws and "
                   "decode"}
       for m in ("elbo_supervised", "elbo_virtual_observables")},
    "models.generative.GenerativeModel.elbo_unsupervised_amortized": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY,
        "decoded": "the port's fused= carries the fused decode's draws and "
                   "decode",
        "_enc": "the port's fused= carries the fused path's encoding too"},
    **{f"models.generative.GenerativeModel.{m}": {
        "params": _STATE, "batch_stats": _STATE, "key": _KEY}
       for m in ("elbo_unsupervised", "elbo")},
    "models.generative.GenerativeModel.propagate_vo_moments": {
        "params": _STATE, "key": _KEY},
    **{f"ops.stencil.{f}": {"interpret": _TPU, "tile_rows": _TPU}
       for f in ("apply_stencil", "apply_stencil_sym")},
    "ops.stencil.apply_stencil_sym_blocked": {"TY": _TPU,
                                              "interpret": _TPU},
    **{f"ops.stencil.{f}": {"TY": _TPU}
       for f in ("pad_blocked", "pad_coefs_blocked", "mask_blocked")},
    "parallel.mesh.shard_train_state": {"state": _STATE},
    "serving.surrogate_fn": {"params": _STATE, "batch_stats": _STATE},
    "serving.SurrogateBundle.build": {"params": _STATE,
                                      "batch_stats": _STATE},
    "training.checkpoint.restore_train_state": {"like": _STATE},
    **{f"training.checkpoint.{f}": {"params": _STATE}
       for f in ("save_encoder_decoder", "restore_encoder_decoder")},
    **{f"utils.params.{f}": {"tree": _STATE}
       for f in ("count_parameters", "global_norm")},
}
# JAX name -> the port's name for it
RENAMED = {
    "convert_scipy_sparse_to_bcoo": "convert_scipy_sparse_to_sparse_coo",
}


def _modules():
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        yield path, ".".join([PORT, *parts])


def _assigned_names(node):
    return [t.id for t in node.targets if isinstance(t, ast.Name)]


def _jax_all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign) and "__all__" in _assigned_names(node):
            return ast.literal_eval(node.value)
    return []


def _public_top_level(tree):
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(_assigned_names(node))
    return {n for n in names if not n.startswith("_")}


def _public_methods(tree):
    for node in tree.body:
        if not isinstance(node, ast.ClassDef) or node.name.startswith("_"):
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                names = [item.name]
            elif isinstance(item, ast.Assign):
                names = _assigned_names(item)
            else:
                continue
            for name in names:
                if not name.startswith("_"):
                    yield node.name, name


def _missing():
    """[(JAX module path, expected port module, name)] of every public
    JAX name with no port counterpart."""
    out = []
    for path, port_name in _modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        try:
            mod = importlib.import_module(port_name)
        except ModuleNotFoundError:
            mod = None
        exported = set(getattr(mod, "__all__", ())) if mod else set()
        rel = str(path.relative_to(ROOT))
        for name in _jax_all(tree):
            if RENAMED.get(name, name) not in exported:
                out.append((rel, port_name, name))
        if path.name != "__init__.py":
            for name in sorted(_public_top_level(tree)):
                if mod is None or not hasattr(mod, RENAMED.get(name, name)):
                    out.append((rel, port_name, name))
            for cls, meth in _public_methods(tree):
                klass = getattr(mod, cls, None) if mod else None
                if klass is not None and not hasattr(klass, meth):
                    out.append((rel, port_name, f"{cls}.{meth}"))
    return out


def test_every_public_jax_name_has_a_port_counterpart():
    missing = _missing()
    unexplained = [m for m in missing if m[2] not in EXCEPTIONS]
    assert not unexplained, unexplained
    # the list does not rot: every exception is still missing
    assert sorted({m[2] for m in missing}) == sorted(EXCEPTIONS)


# the methods and properties of the last API slices (single-system solve,
# FEM and model extras, inference, training and factory accessors; sharded
# training)
METHODS = [
    ("fem.physics", "LinearEllipticPhysics",
     ["solve_full", "solve", "solve_batched_vmap", "dim_in", "dim_out_all"]),
    ("fem.solvers", None, ["CGResult", "cg", "make_fom_solver"]),
    ("fem.assembly", None, ["coo_matvec"]),
    ("fem.forcing", None, ["volume_force", "neumann_force"]),
    ("fem.bc", "BoundaryConditionEnsemble", ["from_encoding", "encode"]),
    ("fem.bc", "DirichletProfile", ["n_constrained"]),
    ("fem.randomfield", "GaussianRandomField", ["sample_numpy", "subspace"]),
    ("fem.randomfield", None, ["squared_exponential_covariance"]),
    ("models.components", "ROM", ["get_stiffness", "dim_in", "dim_out"]),
    ("models.components", "EffectivePropertyMap", ["dim_in"]),
    ("models.components", "ReducedOrderModelOperator", ["dim_in"]),
    ("inference.analysis", "DataPair", ["min", "max"]),
    ("inference.analysis", "Analysis",
     ["sample_predictive_x", "eval_all", "from_encoder"]),
    ("training.trainer", "Trainer", ["mf", "dl", "dlu", "reset"]),
    ("factories.model", "ModelFactory", ["physics"]),
    ("factories.data", "DataFactory",
     ["path", "_cache_meta", "_create_dataloader", "setup", "force_setup"]),
    ("data.loader", "DataSet", ["get"]),
    # sharded training: Trainer.setup(mesh=) and the six sharding names
    ("training.trainer", "Trainer", ["setup"]),
    ("parallel.mesh", None, ["replicated", "batch_sharding",
                             "mc_batch_sharding", "shard_train_state"]),
    ("parallel.distributed", None, ["make_hybrid_mesh",
                                    "global_array_from_local"]),
    ("parallel", None, ["replicated", "batch_sharding", "mc_batch_sharding",
                        "shard_train_state", "make_hybrid_mesh",
                        "global_array_from_local"]),
]


@pytest.mark.parametrize("module,cls,names", METHODS,
                         ids=[f"{m}.{c or ''}" for m, c, _ in METHODS])
def test_api_slice_names_exist(module, cls, names):
    mod = importlib.import_module(f"{PORT}.{module}")
    owner = getattr(mod, cls) if cls else mod
    for name in names:
        assert hasattr(owner, name), f"{module}.{cls}.{name}"


def test_trainer_setup_takes_a_mesh():
    """``Trainer.setup(scheduler_spec, mesh=None)``, as the JAX package's."""
    import inspect

    mod = importlib.import_module(f"{PORT}.training.trainer")
    params = inspect.signature(mod.Trainer.setup).parameters
    assert list(params) == ["self", "scheduler_spec", "mesh"]
    assert params["mesh"].default is None


def _jax_params(fn):
    """The named parameters of a JAX ``def`` (no self / cls, no *args or
    **kwargs)."""
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if p.arg not in ("self", "cls")]


def _port_params(obj):
    """The named parameters of a port callable's signature, or None for a
    counterpart that takes none (a property or a cached attribute)."""
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if isinstance(obj, property):
        obj = obj.fget
    if isinstance(obj, type):
        obj = obj.__init__
    if not callable(obj):
        return None
    return {name for name, p in inspect.signature(obj).parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _keyword_pairs():
    """[("module.Qualname", JAX parameters, port parameters or None)] of
    every public JAX function, method and explicit ``__init__`` whose port
    counterpart exists."""
    out = []
    for path, port_name in _modules():
        if path.name == "__init__.py":
            continue
        try:
            mod = importlib.import_module(port_name)
        except ModuleNotFoundError:
            continue
        prefix = port_name.removeprefix(PORT + ".")
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) \
                    and not node.name.startswith("_"):
                obj = getattr(mod, RENAMED.get(node.name, node.name), None)
                if obj is not None:
                    out.append((f"{prefix}.{node.name}", _jax_params(node),
                                _port_params(obj)))
            elif isinstance(node, ast.ClassDef) \
                    and not node.name.startswith("_") \
                    and hasattr(mod, node.name):
                klass = getattr(mod, node.name)
                for item in node.body:
                    if not isinstance(item, ast.FunctionDef) or (
                            item.name.startswith("_")
                            and item.name != "__init__"):
                        continue
                    obj = inspect.getattr_static(klass, item.name, None)
                    if obj is not None:
                        out.append((f"{prefix}.{node.name}.{item.name}",
                                    _jax_params(item), _port_params(obj)))
    return out


def _missing_keywords():
    missing = {}
    for name, jax_params, port_params in _keyword_pairs():
        for p in jax_params:
            if port_params is None or p not in port_params:
                missing.setdefault(name, set()).add(p)
    return missing


def test_every_jax_keyword_has_a_port_counterpart():
    missing = _missing_keywords()
    unexplained = {name: sorted(ps - set(KEYWORD_EXCEPTIONS.get(name, ())))
                   for name, ps in missing.items()}
    assert not {k: v for k, v in unexplained.items() if v}
    # the table does not rot: every exception is still missing
    stale = {name: sorted(set(ps) - missing.get(name, set()))
             for name, ps in KEYWORD_EXCEPTIONS.items()}
    assert not {k: v for k, v in stale.items() if v}
    assert all(reason for ps in KEYWORD_EXCEPTIONS.values()
               for reason in ps.values())


# the keywords this slice ported, each named (JAX module.Qualname, keyword)
PORTED_KEYWORDS = [
    ("fem.batched_solver.make_batched_fom_solver", "precond_dtype"),
    ("serving.SurrogateBundle.build", "platforms"),
    ("training.trainer.Trainer.export_surrogate", "platforms"),
    ("training.trainer.Trainer.run", "profile_dir"),
    ("training.trainer.CreateTrainerFromPermutation", "BCE_encoding"),
    ("training.trainer.Trainer.FromIdentifier", "dargs"),
    ("factories.data.DataFactory.__init__", "config"),
    ("data.sampling.minibatch_indices", "replace"),
    ("parallel.distributed.initialize", "local_device_ids"),
    ("models.components.ReducedOrderModelOperator.forward_mean", "F"),
    ("models.components.ReducedOrderModelOperator.propagate_samples", "F"),
    ("models.generative.GenerativeModel.apply_g", "F"),
    ("inference.analysis.Analysis.sample_predictive_y", "F"),
]


@pytest.mark.parametrize("name,keyword", PORTED_KEYWORDS,
                         ids=[f"{n}:{k}" for n, k in PORTED_KEYWORDS])
def test_ported_keyword_is_in_both_signatures(name, keyword):
    pairs = {n: (j, p) for n, j, p in _keyword_pairs()}
    jax_params, port_params = pairs[name]
    assert keyword in jax_params and keyword in port_params
