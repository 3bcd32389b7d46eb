"""The port's public API against the JAX package's, module by module.

An ast-only check: it imports neither package, so it runs in about a
second. For every `.py` file of `gtsam_petercdev_tpu/` it reads the file at
the same relative path under `gtsam_petercdev_torch/` and holds

  (a) names: every public top-level def, class and assignment of the JAX
      module is bound in the port's (in `__init__.py` files the names a
      `from ... import ...` brings in count too);
  (b) methods: every public method of a public class is in the port's class
      (or a base class the port's module defines);
  (c) fields: every field of a dataclass or NamedTuple is in the port's
      class, with the same default;
  (d) parameters: every parameter name of a public function or method is a
      parameter of the port's;
  (e) defaults: each parameter default the JAX package gives, as ast text,
      equals the port's once `torch.` and `jnp.` are read as one spelling.

Private names (a leading `_`) and annotations are not compared: a
`jnp.ndarray` against a `torch.Tensor` is no difference. A name the port
leaves out on purpose goes into EXCEPTIONS with its reason; an entry that
no longer matches a difference fails the test, so the list cannot go stale.
"""

import ast
import fnmatch
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "gtsam_petercdev_tpu")
PORT_ROOT = os.path.join(REPO, "gtsam_petercdev_torch")

# Difference ids (fnmatch patterns) -> why the port differs on purpose.
#   "path"                         a JAX module with no port counterpart
#   "path::name"                   a top-level name (a)
#   "path::Class.method"           a method (b)
#   "path::Class.field"            a dataclass / NamedTuple field (c)
#   "path::Class.field="           that field's default (c)
#   "path::func(param)"            a parameter (d)
#   "path::func(param)="           that parameter's default (e)
_NATIVE = "the JAX package's loader and build script for its own .so files; the port loads none"
_VMEM = "TPU VMEM fit checks; the port plans with fits_smem, k1_plan and k2_plan"
_PYTREE = "JAX pytree hooks"
_INTERPRET = "Pallas interpret mode; a CPU tensor takes the kernel's plain version instead"
_MESH = "a jax Mesh; the port takes a torch.distributed process group instead"
_KEY = "a JAX PRNG key / numpy Generator; the port takes a torch.Generator"
_BACKEND = ('JAX\'s "auto" picks the device engine on an accelerator; the port '
            'defaults to the card ("torch")')
_UPOOL = ("the JAX plan's U-pool layout; the port reads a child's Schur complement "
          "through the ext_mm / ext_seg gather-sum plans (internal plan records)")
_DTYPE = ("the port's rule is float64 unless the caller asks (device.resolve_dtype); "
          "the JAX package mixes float32 and float64 defaults, and mixed dtypes raise "
          "in torch matmuls. The parameter names are still compared")

EXCEPTIONS = {
    "native/__init__.py": _NATIVE,
    "native/build.py": _NATIVE,
    "ops/cholesky_v2.py::backsolve_fits": _VMEM,
    "ops/cholesky_v2.py::fits_vmem": _VMEM,
    "nonlinear/values.py::Values.tree_flatten": _PYTREE,
    "nonlinear/values.py::Values.tree_unflatten": _PYTREE,
    "ops/cholesky.py::partial_cholesky(interpret)": _INTERPRET,
    "ops/cholesky.py::partial_cholesky_blocks(interpret)": _INTERPRET,
    "ops/cholesky_v2.py::partial_cholesky(interpret)": _INTERPRET,
    "ops/cholesky_v2.py::backsolve_bucket(interpret)": _INTERPRET,
    "parallel/partition.py::PartitionedSolver.__init__(mesh)": _MESH,
    "parallel/mesh.py::distributed_normal_equations(mesh)": _MESH,
    "parallel/mesh.py::distributed_gn_step(mesh)": _MESH,
    "parallel/mesh.py::make_mesh(n_devices)": _MESH,
    "parallel/mesh.py::make_mesh(axis)": _MESH,
    "linear/sampler.py::sample_diagonal(key)": _KEY,
    "linear/sampler.py::sample_sqrt_info(key)": _KEY,
    "discrete/discrete.py::DiscreteBayesNet.sample(rng)": _KEY,
    "inference/incremental.py::IncrementalEngine.__init__(backend)=": _BACKEND,
    "nonlinear/isam2.py::ISAM2Params.engine_backend=": _BACKEND,
    "inference/elimination.py::BucketMaps.u_base": _UPOOL,
    "inference/elimination.py::BucketMaps.ug_base": _UPOOL,
    "inference/elimination.py::BucketMaps.ext_pull": _UPOOL,
    "inference/elimination.py::BucketMaps.extg_pull": _UPOOL,
    "inference/elimination.py::NumericMaps.slot_dims": _UPOOL,
    "inference/elimination.py::NumericMaps.slot_gids": _UPOOL,
    "inference/elimination.py::NumericMaps.var_diag_rows": _UPOOL,
    "inference/elimination.py::NumericMaps.n_ublocks": _UPOOL,
    "inference/elimination.py::NumericMaps.n_ugrows": _UPOOL,
    "*(dtype)=": _DTYPE,
}


def _public(name):
    return not name.startswith("_")


def _norm(text):
    return re.sub(r"\b(jnp|torch)\.", "xp.", text)


def _is_dataclass(cls):
    for dec in cls.decorator_list:
        if "dataclass" in ast.unparse(dec):
            return True
    return any(ast.unparse(b).split(".")[-1] == "NamedTuple" for b in cls.bases)


def _top_bindings(body, with_imports):
    """name -> node for the names a module body binds at its top level
    (descending into top-level if / try blocks)."""
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) else [tgt]
                for n in elts:
                    if isinstance(n, ast.Name):
                        out[n.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and with_imports:
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = node
        elif isinstance(node, ast.If):
            if ast.unparse(node.test).replace("'", '"') == '__name__ == "__main__"':
                continue
            out.update(_top_bindings(node.body + node.orelse, with_imports))
        elif isinstance(node, ast.Try):
            inner = node.body + node.orelse + node.finalbody
            for h in node.handlers:
                inner += h.body
            out.update(_top_bindings(inner, with_imports))
    return out


def _class_members(cls, module):
    """(methods, fields) of a class, its in-module bases' first:
    methods name -> FunctionDef (or None for a class-level assignment),
    fields name -> default text (None without a default)."""
    methods, fields = {}, {}
    for base in cls.bases:
        b = module.get(ast.unparse(base))
        if isinstance(b, ast.ClassDef) and b is not cls:
            m, f = _class_members(b, module)
            methods.update(m)
            fields.update(f)
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[node.name] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            fields[node.target.id] = None if node.value is None else ast.unparse(node.value)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    methods[tgt.id] = None
    return methods, fields


def _own_fields(cls):
    return {
        n.target.id: None if n.value is None else ast.unparse(n.value)
        for n in cls.body
        if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
    }


def _params(fn):
    """name -> default text (None without one) for a function's parameters."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + [ast.unparse(d) for d in a.defaults]
    out = {p.arg: d for p, d in zip(pos, defaults)}
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        out[p.arg] = None if d is None else ast.unparse(d)
    for p in (a.vararg, a.kwarg):
        if p is not None:
            out[p.arg] = None
    return out


def _compare_fn(where, jfn, pfn, diffs):
    jp, pp = _params(jfn), _params(pfn)
    for name, default in jp.items():
        if name not in pp:
            diffs.append(f"{where}({name})")
        elif default is not None and (pp[name] is None or _norm(pp[name]) != _norm(default)):
            diffs.append(f"{where}({name})=")


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _module_diffs(rel):
    jtree, ptree = _parse(os.path.join(JAX_ROOT, rel)), _parse(os.path.join(PORT_ROOT, rel))
    is_init = os.path.basename(rel) == "__init__.py"
    jmod = _top_bindings(jtree.body, with_imports=is_init)
    pmod = _top_bindings(ptree.body, with_imports=True)
    diffs = []
    for name, jnode in jmod.items():
        if not _public(name):
            continue
        pnode = pmod.get(name)
        if pnode is None:
            diffs.append(f"{rel}::{name}")
            continue
        if isinstance(jnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(pnode, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _compare_fn(f"{rel}::{name}", jnode, pnode, diffs)
        elif isinstance(jnode, ast.ClassDef):
            if not isinstance(pnode, ast.ClassDef):
                continue
            jmethods, _ = _class_members(jnode, jmod)
            pmethods, pfields = _class_members(pnode, pmod)
            for mname, jfn in jmethods.items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                if mname not in pmethods and mname not in pfields:
                    diffs.append(f"{rel}::{name}.{mname}")
                elif jfn is not None and isinstance(pmethods.get(mname), ast.FunctionDef):
                    _compare_fn(f"{rel}::{name}.{mname}", jfn, pmethods[mname], diffs)
            if _is_dataclass(jnode):
                for fname, default in _own_fields(jnode).items():
                    if fname not in pfields:
                        diffs.append(f"{rel}::{name}.{fname}")
                    elif default is not None and (
                        pfields[fname] is None or _norm(pfields[fname]) != _norm(default)
                    ):
                        diffs.append(f"{rel}::{name}.{fname}=")
    return diffs


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), JAX_ROOT))
    return sorted(out)


def api_differences(rel):
    """The difference ids of one JAX module against its port counterpart."""
    if not os.path.exists(os.path.join(PORT_ROOT, rel)):
        return [rel]
    return _module_diffs(rel)


def _excepted(diff):
    return any(fnmatch.fnmatchcase(diff, p) for p in EXCEPTIONS)


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_module_api_matches_jax(rel):
    unexplained = [d for d in api_differences(rel) if not _excepted(d)]
    assert not unexplained, "the port lacks:\n  " + "\n  ".join(unexplained)


def test_api_exceptions_are_current():
    diffs = [d for rel in _jax_modules() for d in api_differences(rel)]
    stale = [p for p in EXCEPTIONS if not any(fnmatch.fnmatchcase(d, p) for d in diffs)]
    assert not stale, "exception entries that match no difference: " + ", ".join(stale)
