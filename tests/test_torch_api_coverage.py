"""The port covers the JAX package's public API, name by name.

The JAX package is read with ``ast`` only (never imported): its
subpackages' ``__all__`` lists, the public top-level names of each of its
modules, and the public methods of its classes.  Each must have a
counterpart in the port's module of the same path, except the names of
``EXCEPTIONS`` (each with its reason) and the renames of ``RENAMED``.  The
methods the port added in its last API slice are named one by one too.
"""

import ast
import importlib
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
    "SurrogateBundle.platforms": "StableHLO multi-platform export",
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
