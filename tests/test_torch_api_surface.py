"""The port's public surface against the JAX package's, by AST (no JAX is
imported here).

- Package by package (tests/test_api_surface.py's walk, over ``atq_tpu``
  here): every name that ``atq_tpu``, ``.core``, ``.nn``, ``.models``,
  ``.data``, ``.utils``, ``.parallel``, ``.losses``, ``.serve``,
  ``.train`` and ``.ops`` export has a counterpart in the same
  ``atq_tpu_torch`` package's ``__all__``, under the same name or its
  ``RENAMED`` one.
- Module by module: every public top-level function or class of every
  ``atq_tpu/**.py`` has a counterpart in the port's module of the same
  path: a top-level name of the same name (a definition, an assignment or
  an import), or an entry of ``RENAMED`` (where the port keeps it under
  another name, and the reason) or of ``JAX_ONLY`` (what the port has no
  use for, and the reason). A new public name in ``atq_tpu`` without one
  fails; so does an entry that no longer names a JAX function, or a
  ``JAX_ONLY`` name that the port has after all.
- Importing the packages builds and loads no CUDA source.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_ROOT, PORT_ROOT = REPO / "atq_tpu", REPO / "atq_tpu_torch"
PACKAGES = ["", "core", "nn", "models", "data", "utils", "parallel",
            "losses", "serve", "train", "ops"]
# (module, JAX name) -> (the port's module and name, why it differs).
RENAMED = {
    ("nn/layers.py", "quantized_weight_policy"):
        ("nn/transformer.py", "REMAT_POLICIES",
         "a remat_policy value, 'save_quantized'"),
    ("nn/layers.py", "quantized_weight_and_dots_policy"):
        ("nn/transformer.py", "REMAT_POLICIES",
         "a remat_policy value, 'save_dots'"),
    ("utils/platform.py", "apply_platform_env"):
        ("utils/platform.py", "resolve_device", "the device an entry point "
         "runs on; sets no environment"),
    ("ops/ternary_matmul.py", "pallas_eligible"):
        ("ops/ternary_matmul.py", "kernel_eligible", "no Pallas"),
    ("nn/initializers.py", "kaiming_uniform_torch"):
        ("nn/initializers.py", "kaiming_uniform_torch_",
         "in place, as torch.nn.init"),
    ("nn/initializers.py", "bias_uniform_torch"):
        ("nn/initializers.py", "bias_uniform_torch_",
         "in place, as torch.nn.init"),
    ("nn/initializers.py", "xavier_uniform_gain"):
        ("nn/initializers.py", "xavier_uniform_gain_",
         "in place, as torch.nn.init"),
    ("nn/initializers.py", "normal_std"):
        ("nn/initializers.py", "normal_std_", "in place, as torch.nn.init"),
}
# (module, JAX name) -> why the port has no counterpart.
JAX_ONLY = {
    ("serve/packed_model.py", "StaticShape"): "a jit static leaf",
    ("ops/ternary_matmul.py", "pallas_disabled"):
        "the Pallas kill switch; a CUDA tensor launches or raises",
    ("ops/ternary_matmul.py", "pallas_interpret"): "the Pallas interpreter",
    ("ops/order_stat.py", "order_stat_eligible"):
        "the TPU's VMEM budget and the kill switch",
    ("nn/hoist.py", "make_hoist_transform"): "flax map_variables",
    ("utils/platform.py", "enable_compilation_cache"):
        "XLA's compilation cache",
    ("utils/platform.py", "force_platform_from_argv"): "JAX's platform flag",
    ("utils/flops.py", "compiled_flops"):
        "XLA's cost analysis; counted_flops counts instead",
    ("native/__init__.py", "available"):
        "the numpy fallback's probe; a failed build raises",
    ("train/checkpoint.py", "wait_for_checkpoints"): "Orbax's async saves",
}
PACKAGE_RENAMED = {name: port for (_, name), (_, port, _) in RENAMED.items()}
JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT))
                     for p in JAX_ROOT.rglob("*.py"))


def _tree(path):
    return ast.parse(path.read_text())


def _jax_all(pkg):
    for node in ast.walk(_tree(JAX_ROOT / pkg / "__init__.py")):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [e.value for e in node.value.elts]
    return []


def _public_defs(module):
    """The public top-level functions and classes of an atq_tpu module."""
    return [n.name for n in _tree(JAX_ROOT / module).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _top_level_names(module):
    """Every name a port module binds at its top level."""
    names = set()
    for n in _tree(PORT_ROOT / module).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign)
                      else [n.target]):
                names.update(e.id for e in ast.walk(t)
                             if isinstance(e, ast.Name))
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
    return names


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "root" for p in
                                                PACKAGES])
def test_every_jax_export_has_a_counterpart(pkg):
    names = _jax_all(pkg)
    assert names, pkg
    mod = importlib.import_module(".".join(filter(None, ["atq_tpu_torch",
                                                         pkg])))
    for name in names:
        ported = PACKAGE_RENAMED.get(name, name)
        assert ported in mod.__all__, (pkg, name)
        assert getattr(mod, ported) is not None
    assert set(mod.__all__) <= set(dir(mod))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    assert (PORT_ROOT / module).exists(), f"no port of atq_tpu/{module}"
    port_names = _top_level_names(module)
    missing = []
    for name in _public_defs(module):
        key = (module, name)
        if key in RENAMED:
            where, ported, reason = RENAMED[key]
            assert reason and ported in _top_level_names(where), key
        elif key in JAX_ONLY:
            assert JAX_ONLY[key], key
            assert name not in port_names, f"{key} is ported: not JAX_ONLY"
        elif name not in port_names:
            missing.append(name)
    assert not missing, (f"atq_tpu/{module}: {missing} have no counterpart "
                         f"in atq_tpu_torch/{module} and no RENAMED or "
                         f"JAX_ONLY entry")


def test_every_table_entry_names_a_jax_function():
    for module, name in list(RENAMED) + list(JAX_ONLY):
        assert name in _public_defs(module), (module, name)


def test_renamed_policies_are_remat_policies():
    from atq_tpu_torch.nn import REMAT_POLICIES

    assert {"save_quantized", "save_dots"} <= set(REMAT_POLICIES)


def test_importing_the_packages_builds_nothing():
    script = (
        "import importlib, sys\n"
        f"for p in {PACKAGES!r}:\n"
        "    importlib.import_module('.'.join(filter(None, "
        "['atq_tpu_torch', p])))\n"
        "import atq_tpu_torch.ops._build as b, atq_tpu_torch.native as n\n"
        "assert b._lib is None and not b.build_info\n"
        "assert n._lib is None\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'atq_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
