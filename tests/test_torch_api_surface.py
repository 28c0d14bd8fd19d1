"""The port's package exports against the JAX package's ``__all__`` lists
(tests/test_api_surface.py's walk, over ``atq_tpu`` here): every name that
``atq_tpu``, ``.core``, ``.nn``, ``.models``, ``.data``, ``.utils``,
``.parallel`` and ``.losses`` export has a counterpart in the same
``atq_tpu_torch`` package's ``__all__``, under the same name or a
documented one; ``MULTI_PROCESS``, the names once left for the scale-out
slice, is empty now. Importing the packages builds and loads no CUDA
source.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ["", "core", "nn", "models", "data", "utils", "parallel",
            "losses"]
# JAX name -> the port's: a policy function is a remat_policy value of
# the scanned stack here, and the platform setup is resolve_device.
RENAMED = {"quantized_weight_policy": "REMAT_POLICIES",
           "quantized_weight_and_dots_policy": "REMAT_POLICIES",
           "apply_platform_env": "resolve_device"}
MULTI_PROCESS = set()


def _jax_all(pkg):
    init = REPO / "atq_tpu" / pkg / "__init__.py"
    for node in ast.walk(ast.parse(init.read_text())):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return [e.value for e in node.value.elts]
    return []


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "root" for p in
                                                PACKAGES])
def test_every_jax_export_has_a_counterpart(pkg):
    names = _jax_all(pkg)
    assert names, pkg
    mod = importlib.import_module(".".join(filter(None, ["atq_tpu_torch",
                                                         pkg])))
    for name in names:
        if name in MULTI_PROCESS:
            assert not hasattr(mod, name), name
            continue
        ported = RENAMED.get(name, name)
        assert ported in mod.__all__, (pkg, name)
        assert getattr(mod, ported) is not None
    assert set(mod.__all__) <= set(dir(mod))


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
