"""The port's public surface against the JAX package's.

Every module of `arrow_tpu/` is read by AST (one case a module) and held
to its counterpart in `arrow_tpu_torch/` (`compute.py` for
`ops/__init__.py`): each public module-level name, each public method,
property and special method of each public class, and each parameter
name of those functions must be there.  The port may add parameters
(a `device`, say), never lose one.  What the port leaves out on purpose
is listed in NOT_PORTED with its reason (ROADMAP A, "Not ported:
TPU-only code"); a name added to the reference later fails here until
it is ported or listed.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pathlib

import pytest

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "arrow_tpu"

_TRACED = "a jax.jit-traced variant; the port runs eagerly on the device"
_PYTREE = "jax pytree hooks; the port registers torch pytrees instead"
_AXIS = ("a jax mesh axis name; a communicator bound to one shard takes "
         "its place")
_MESH = "jax devices; make_mesh(n_shards, device) names the torch device"

NOT_PORTED = {
    "config.py:platform": "the jax backend's name; the port routes by the "
                          "tensor's device",
    "config.py:on_tpu": "a TPU probe; there is no TPU in the port",
    "config.py:use_pallas": "the Pallas switch; the port has no switch: "
                            "CUDA tensors take the kernels",
    "dtypes.py:DataType.to_jax": "the jax dtype; the port's is to_torch",
    "fuse.py:fuse(jit_kwargs)": "jax.jit's options; the port captures "
                                "CUDA graphs",
    "kernels/compact.py:compact_mask_arrays": "the u32-plane Pallas entry; "
                                              "K1 takes native widths",
    "kernels/compact.py:compact_planes": "the u32-plane Pallas entry; K1 "
                                         "takes native widths",
    "kernels/compact.py:supported_dtype": "the TPU's f64/f16 exclusion; K1 "
                                          "takes every width",
    "kernels/dispatch.py": "Pallas interpret mode and use_pallas; the port "
                           "routes by the tensor's device",
    "kernels/segagg.py": "folded into kernels/groupagg.py",
    "kernels/groupminmax.py": "folded into kernels/groupagg.py",
    "utils/native.py": "the reference's ctypes loader; the port's is "
                       "utils/hostcodec.py",
    "ops/row_format.py:jax_bitcast_u64": "a TPU bitcast workaround; torch "
                                         "views the bits",
    "ops/row_format.py:lexsort_indices_from_keys": "lax.sort over key "
                                                   "tuples; the port sorts "
                                                   "packed words",
    "ops/row_format.py:encode_keys_traced": _TRACED,
    "ops/row_format.py:encode_key_groups_traced": _TRACED,
    "ops/row_format.py:lexsort_order_traced": _TRACED,
    "ops/row_format.py:key_parts(opt)": "the traced key's sort options; "
                                        "the port's keys carry them",
    "parallel/__init__.py:P": "jax.sharding.PartitionSpec; shard_map takes "
                              "0, 1 or None",
    "parallel/mesh.py:make_mesh(n_devices)": _MESH,
    "parallel/mesh.py:make_mesh(devices)": _MESH,
    **{f"parallel/dist.py:{f}(axis)": _AXIS for f in (
        "dist_group_by", "dist_group_by_stream", "dist_sum",
        "dist_join_unique", "dist_join_stream", "dist_join", "dist_sort",
        "dist_join_skew")},
    **{f"parallel/partition.py:{f}(axis)": _AXIS for f in (
        "exchange", "repartition_arrays")},
}


# methods left out of every class
NOT_PORTED_MEMBERS = {"tree_flatten": _PYTREE, "tree_unflatten": _PYTREE}


def _modules():
    return sorted(str(p.relative_to(REFERENCE))
                  for p in REFERENCE.rglob("*.py"))


def _port_module(rel: str) -> str:
    if rel == "ops/__init__.py":
        return "arrow_tpu_torch.compute"
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["arrow_tpu_torch"] + parts)


def _public(name: str) -> bool:
    return not name.startswith("_")


def _special(name: str) -> bool:
    return name.startswith("__") and name.endswith("__") \
        and name != "__init__"


def _params(fn: ast.FunctionDef):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _top_names(node, init: bool):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return [node.name]
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    if init and isinstance(node, ast.ImportFrom):
        return [a.asname or a.name for a in node.names if a.name != "*"]
    return []


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in fn.decorator_list)


def _missing_params(key, fn, port_fn, missing):
    try:
        sig = inspect.signature(port_fn).parameters
    except (TypeError, ValueError):
        return
    if any(p.kind == p.VAR_KEYWORD for p in sig.values()):
        return
    missing += [f"{key}({p})" for p in _params(fn) if p not in sig]


def _surface_gaps(rel: str):
    """What the reference module `rel` has and the port lacks."""
    tree = ast.parse((REFERENCE / rel).read_text())
    try:
        port = importlib.import_module(_port_module(rel))
    except ModuleNotFoundError:
        return [rel]
    init = rel.endswith("__init__.py")
    missing = []
    for node in tree.body:
        for name in filter(_public, _top_names(node, init)):
            key = f"{rel}:{name}"
            if not hasattr(port, name):
                missing.append(key)
                continue
            obj = getattr(port, name)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _missing_params(key, node, obj, missing)
            if not isinstance(node, ast.ClassDef):
                continue
            for m in node.body:
                if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        or not (_public(m.name) or _special(m.name)):
                    continue
                mkey = f"{key}.{m.name}"
                if not hasattr(obj, m.name):
                    missing.append(mkey)
                elif _is_property(m) and not isinstance(
                        inspect.getattr_static(obj, m.name), property):
                    missing.append(f"{mkey} (a property in the reference)")
                elif not _is_property(m):
                    _missing_params(mkey, m, getattr(obj, m.name), missing)
    return missing


def _listed(key: str) -> bool:
    if key in NOT_PORTED or key.split(":")[0] in NOT_PORTED:
        return True
    return key.partition(":")[2].split(".")[-1] in NOT_PORTED_MEMBERS


@pytest.mark.parametrize("rel", _modules())
def test_module_surface(rel):
    gaps = [k for k in _surface_gaps(rel) if not _listed(k)]
    assert not gaps, f"{rel}: the port lacks {gaps} (port it or list it " \
                     "in NOT_PORTED with its reason)"


def test_not_ported_entries_name_real_gaps():
    """Every NOT_PORTED entry has a reason and names something the port
    really lacks: a ported name leaves the table."""
    gaps = {k for rel in _modules() for k in _surface_gaps(rel)}
    for key, reason in NOT_PORTED.items():
        assert reason.strip(), key
        assert key in gaps, f"{key} is ported: take it out of NOT_PORTED"


def test_pytree_hooks_are_torch_pytrees():
    """The reference's tree_flatten / tree_unflatten pairs
    (NOT_PORTED_MEMBERS): the port's classes are torch pytree nodes
    instead."""
    from torch.utils import _pytree as pytree
    import arrow_tpu_torch as att
    t = att.Table.from_pydict({"a": [1, None], "s": ["x", "y"]},
                              device="cpu")
    leaves, spec = pytree.tree_flatten(t)
    assert leaves and pytree.tree_unflatten(leaves, spec).equals(t)
