"""The port's ahead-of-time serving programs (atq_tpu_torch/serve/aot.py,
``serve --aot``) on the CPU: the cases of tests/test_aot.py, and the
exported graphs' kernels.

An exported program must equal the live function bit for bit (the same
ATen and registered ops run in the same order), at batch sizes never seen
at export time and at 1, before and after a save/load round trip. The
serve CLI's ``--aot`` (export, then load) must equal the live port bit for
bit and JAX's ``serve.py --aot`` within the serving test's tolerance
(tests/test_torch_serve.py; the retrieval CLI is in
tests/test_torch_aot_retrieval.py). Every program
must hold the ``atq_tpu_torch::`` op of each kernel its forward reaches,
and not the plain version (``aten.sort``, a decode by shifts) in its
place: on the CPU a kernel wrapper's plain version would export as
ordinary ATen ops and the artifact would hold no kernel.
"""

import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.train.classifier import _save_checkpoint
from atq_tpu_torch.serve.__main__ import (
    build_classifier,
    build_classifier_routes,
    build_parser,
)
from atq_tpu_torch.serve.aot import (
    AOTServing,
    export_serving,
    load_serving,
)
from atq_tpu_torch.serve.engine import BatchServer
from atq_tpu_torch.serve.packed_model import (
    attach_packed_collection,
    export_packed_collection,
)
from atq_tpu_torch.utils.jax_interop import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CLF_TOL = 1e-5  # tests/test_torch_serve.py


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mlp():
    rng = np.random.RandomState(0)
    w1 = torch.from_numpy(rng.randn(16, 32).astype(np.float32))
    w2 = torch.from_numpy(rng.randn(32, 8).astype(np.float32))

    def fn(x):
        return torch.tanh(x @ w1) @ w2

    return fn


def _x(seed, n, d=16):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(n, d).astype(np.float32))


def test_poly_export_matches_and_roundtrips(tmp_path):
    fn = _mlp()
    aot = export_serving(fn, (_x(1, 4),))
    assert aot.batch_polymorphic and aot.platforms == ("cpu",)
    for n in (4, 7, 1):  # 7 and 1 never seen at export time
        assert torch.equal(aot(_x(n, n)), fn(_x(n, n)))
    path = aot.save(str(tmp_path / "mlp"))
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["format"] == "atq_tpu_torch.aot.v1"
    assert set(manifest) == {"format", "poly", "exports", "arg_specs",
                             "platforms", "torch_version"}
    loaded = load_serving(path)
    assert loaded.batch_polymorphic
    for n in (7, 1):
        assert torch.equal(loaded(_x(n, n)), fn(_x(n, n)))
    # numpy in, numpy out (the BatchServer contract)
    np.testing.assert_array_equal(loaded(_x(2, 3).numpy()),
                                  fn(_x(2, 3)).numpy())


def test_bucketed_export_pads_and_slices(tmp_path):
    fn = _mlp()
    x = _x(3, 8)
    aot = export_serving(fn, (x,), batch_polymorphic=False, buckets=(4, 8))
    assert not aot.batch_polymorphic
    assert torch.equal(aot(x[:3]), fn(x[:3]))  # pads to 4, slices to 3
    assert torch.equal(aot(x), fn(x))
    with pytest.raises(ValueError):
        aot(torch.zeros(9, 16))
    loaded = load_serving(aot.save(str(tmp_path / "bucketed")))
    assert torch.equal(loaded(x[:3]), fn(x[:3]))


def test_symbolic_batch_refused_falls_back_to_buckets():
    def fn(x):
        return x * 2 if x.shape[0] > 3 else x

    with pytest.warns(UserWarning, match="batch-polymorphic export failed"):
        aot = export_serving(fn, (_x(0, 4),), buckets=(4, 6))
    assert not aot.batch_polymorphic
    assert torch.equal(aot(_x(1, 5)), fn(torch.cat([_x(1, 5),
                                                     torch.zeros(1, 16)]))[:5])


def test_multi_arg_and_tuple_output():
    w = torch.from_numpy(np.random.RandomState(4).randn(16, 8).astype(
        np.float32))

    def fn(x, lengths):
        h = x @ w
        return h, h.sum(-1) * lengths.float()

    x, ln = _x(4, 5), torch.arange(5)
    got = export_serving(fn, (x, ln))(x, ln)
    want = fn(x, ln)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_bucketed_tuple_output_slices_every_leaf():
    w = torch.from_numpy(np.random.RandomState(6).randn(16, 8).astype(
        np.float32))

    def fn(x):
        h = x @ w
        return h, h.sum(-1)

    x = _x(6, 6)
    got = export_serving(fn, (x,), batch_polymorphic=False, buckets=(8,))(x)
    for g, w_ in zip(got, fn(x)):
        assert g.shape[0] == 6
        assert torch.equal(g, w_)


def test_aot_fronts_batch_server():
    fn = _mlp()
    x = _x(5, 4)
    aot = export_serving(fn, (x,))
    with BatchServer(aot, max_batch=8, max_wait_ms=1.0) as server:
        futs = [server.submit(x[i].numpy()) for i in range(4)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30),
                                          fn(x).numpy()[i])


def test_manifest_format_guard(tmp_path):
    from atq_tpu.serve.aot import export_serving as jax_export_serving

    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not an atq_tpu_torch.aot.v1"):
        AOTServing.load(str(bad))
    jax_dir = str(tmp_path / "jax")  # a real JAX artifact
    jax_export_serving(jax.jit(lambda x: x * 2.0),
                       (np.zeros((2, 3), np.float32),)).save(jax_dir)
    with pytest.raises(ValueError, match="atq_tpu.aot.v1.*"
                                         "atq_tpu_torch.aot.v1"):
        AOTServing.load(jax_dir)
    cuda = str(tmp_path / "cuda")  # a cuda artifact on a host without one
    export_serving(_mlp(), (_x(0, 2),)).save(cuda)
    manifest = json.load(open(os.path.join(cuda, "manifest.json")))
    manifest["platforms"] = ["cuda"]
    json.dump(manifest, open(os.path.join(cuda, "manifest.json"), "w"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            AOTServing.load(cuda)


# ---------------------------------------------------------------------------
# The exported graphs' kernels.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clf(tmp_path_factory):
    model = JaxClassifier(use_rpb=True, hidden_size=128)
    v = jax.tree_util.tree_map(np.array, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1))))
    for layer in ("classifier_0", "classifier_3"):  # a trained-size alpha
        v["params"][layer]["alpha"] = np.full((1,), 0.02, np.float32)
    path = str(tmp_path_factory.mktemp("clf") / "atq_model.npz")
    _save_checkpoint(v, path)
    return model, v, path


def _clf_args(path, *extra):
    return build_parser().parse_args(
        ["--task", "classification", "--checkpoint", path, "--use-rpb",
         "--device", "cpu", *extra])


def _ops(aot):
    (ep,) = aot.programs.values()
    return Counter(str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function")


def _kernel_ops(ops):
    return {k.split(".")[1]: v for k, v in ops.items()
            if k.startswith("atq_tpu_torch.")}


def _images(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        n, 28, 28, 1).astype(np.float32))


def _export_clf(model):
    aot = export_serving(model, (_images(2),))
    assert aot.batch_polymorphic
    for n in (1, 5):
        with torch.inference_mode():
            want = model(_images(n, seed=n))
        assert torch.equal(aot(_images(n, seed=n)), want)
    return _ops(aot)


# route -> (environment, sparse correction, packed, expected kernel ops,
# expected aten.sort: the head's second layer, 1,280 weights, is below
# the order statistic's 16,384 and sorts, as JAX's XLA path does)
ROUTES = {
    "order_stat": ({}, True, False, {"order_stat": 1}, 1),
    "planar": ({}, True, True, {"ternary_matmul": 2}, 0),
    "planar32": ({"ATQ_PACK32": "1"}, True, True,
                 {"ternary_matmul32": 2}, 0),
    "rpb": ({}, False, True, {"ternary_matmul_rpb": 2}, 0),
    "fused_forward": ({"ATQ_FUSED": "1"}, True, False,
                      {"fused_forward": 2, "order_stat": 1}, 1),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_exported_graph_holds_the_kernel_ops(clf, route, monkeypatch):
    env, sparse, packed, want, sorts = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, v, path = clf
    ckpt = load_checkpoint(path)
    model = build_classifier(_clf_args(path), ckpt, "parity", CPU)
    if packed:
        attach_packed_collection(model, export_packed_collection(
            ckpt["params"], ckpt["quant"], device=CPU,
            sparse_correction=sparse))
    ops = _export_clf(model)
    assert _kernel_ops(ops) == want
    assert ops["aten.sort.default"] == sorts
    decodes = [k for k in ops if "shift" in k]
    assert not decodes, decodes


def _opcheck_cases():
    from atq_tpu_torch.core.packing import pack_planar, pack_planar32

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 200).astype(np.float32))
    w = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], (16, 200)).astype(
        np.float32))
    avec = torch.tensor([0.5, 0.4])
    corr = torch.from_numpy(rng.randn(16, 200).astype(np.float32)).to(
        torch.bfloat16)
    mask = torch.from_numpy(rng.rand(16, 200) < 0.1)
    scal = torch.tensor([0.3, 0.5])
    ops = torch.ops.atq_tpu_torch
    return {
        "order_stat": (ops.order_stat.default,
                       (x.abs().reshape(-1), torch.tensor([37],
                                                          dtype=torch.int32))),
        "order_stat_batched": (ops.order_stat_batched.default,
                               (x.abs(), torch.tensor([0, 5, 199],
                                                      dtype=torch.int32))),
        "ternary_matmul": (ops.ternary_matmul.default,
                           (x, pack_planar(w), 200, avec, True)),
        "ternary_matmul32": (ops.ternary_matmul32.default,
                             (x, pack_planar32(w), 200, avec, False)),
        "ternary_matmul_rpb": (ops.ternary_matmul_rpb.default,
                               (x, pack_planar(w), corr, 200, avec)),
        "fused_forward": (ops.fused_forward.default, (x, w, mask, scal)),
        "fused_forward_nomask": (ops.fused_forward.default,
                                 (x, w, None, scal)),
    }


@pytest.mark.parametrize("case", list(_opcheck_cases()))
def test_opcheck(case):
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


# ---------------------------------------------------------------------------
# The serve CLI's --aot against the live port and against serve.py --aot.
# ---------------------------------------------------------------------------

def _stop(servers):
    for s in servers:
        s.stop()


def _aot_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"aot"')]


def test_serve_cli_aot_classifier(clf, tmp_path, capsys):
    import serve as jax_serve
    from atq_tpu.train.classifier import load_checkpoint as jax_load

    _, _, path = clf
    payloads = [{"image": np.random.RandomState(i).rand(28, 28).tolist(),
                 "normalize": True} for i in range(3)]
    args = _clf_args(path, "--packed", "--aot", str(tmp_path / "aot"),
                     "--max_wait_ms", "1")
    ckpt = load_checkpoint(path)
    answers = {}
    for run in ("exported", "loaded", "live"):
        if run == "live":
            args.aot = None
        routes, servers = build_classifier_routes(args, ckpt, "parity", CPU)
        try:
            answers[run] = [routes["/predict"](p) for p in payloads]
        finally:
            _stop(servers)
    lines = _aot_lines(capsys)
    assert [x["aot"] for x in lines] == ["exported", "loaded"]
    assert all(x["batch_polymorphic"] for x in lines)
    for run in ("exported", "loaded"):
        assert answers[run] == answers["live"]

    jax_args = jax_serve.build_parser().parse_args(
        ["--task", "classification", "--checkpoint", path, "--use-rpb",
         "--packed", "--aot", str(tmp_path / "jax"), "--max_wait_ms", "1"])
    routes, servers = jax_serve.build_classifier_routes(
        jax_args, jax_load(path), "parity")
    try:
        want = [routes["/predict"](p) for p in payloads]
    finally:
        _stop(servers)
    np.testing.assert_allclose([a["logits"] for a in answers["loaded"]],
                               [a["logits"] for a in want], rtol=CLF_TOL,
                               atol=CLF_TOL)


def test_load_needs_no_model_module(clf, tmp_path):
    """A saved program loads and runs in a process that imports no
    ``atq_tpu_torch.models``, and equals the live model bit for bit."""
    _, _, path = clf
    ckpt = load_checkpoint(path)
    model = build_classifier(_clf_args(path, "--packed"), ckpt, "parity",
                             CPU)
    export_serving(model, (_images(2),)).save(str(tmp_path / "predict"))
    x = _images(3, seed=9)
    np.save(tmp_path / "x.npy", x.numpy())
    code = (
        "import sys, numpy as np\n"
        "from atq_tpu_torch.serve.aot import load_serving\n"
        f"aot = load_serving({str(tmp_path / 'predict')!r})\n"
        f"y = aot(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y)\n"
        "mods = [m for m in sys.modules if m.startswith("
        "('atq_tpu_torch.models', 'atq_tpu.', 'jax'))]\n"
        "assert not mods, mods\n")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    with torch.inference_mode():
        want = model(x).numpy()
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)
