"""The port's serving CLI (``python -m atq_tpu_torch.serve``) on the CPU
against the JAX model on the same JAX-written checkpoint.

A full-width JAX ``ATQImageClassifier`` (28x28 input, 3136 -> 128 -> 10 RPB
head) is written with the JAX trainer's own ``.npz`` writer; the port's
route builder serves it over real HTTP with ``device="cpu"``, dense and
``--packed``. Answers must match ``model.apply`` (dense) and ``model.apply``
with the JAX export (packed) to rtol 1e-5 / atol 1e-5.
"""

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atq_tpu.data.mnist import _synthetic
from atq_tpu.models.image_classifier import (
    ATQImageClassifier as JaxClassifier,
)
from atq_tpu.serve.packed_model import (
    export_packed_collection as jax_export_packed_collection,
)
from atq_tpu.train.classifier import _save_checkpoint
from atq_tpu_torch.data.mnist import FASHION_STATS, synthetic_test_set
from atq_tpu_torch.serve.__main__ import build_server, resolve_grad_mode
from atq_tpu_torch.serve.http import start_in_thread

N_REQUESTS = 6


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model = JaxClassifier(use_rpb=True, hidden_size=128)
    v = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1))))
    v = jax.tree_util.tree_map(lambda a: a.copy(), v)
    for layer in ("classifier_0", "classifier_3"):  # a trained-size alpha
        v["params"][layer]["alpha"] = np.full((1,), 0.02, np.float32)
    path = tmp_path_factory.mktemp("ckpt") / "atq_model_fashion_mnist.npz"
    _save_checkpoint(v, str(path))
    return model, v, str(path)


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("packed", [False, True])
def test_http_predict_matches_jax(checkpoint, packed):
    model, v, path = checkpoint
    images = synthetic_test_set("fashion_mnist", N_REQUESTS)[0] / 255.0
    argv = ["--task", "classification", "--checkpoint", path, "--use-rpb",
            "--port", "0", "--device", "cpu"] + (["--packed"] * packed)
    httpd, servers, info = build_server(argv)
    start_in_thread(httpd)
    try:
        port = info["port"]
        with ThreadPoolExecutor(N_REQUESTS) as pool:
            answers = list(pool.map(
                lambda img: _post(port, {"image": img.tolist(),
                                         "normalize": True}), images))
        stats = _get(port, "/healthz")["stats"]["server_0"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        for s in servers:
            s.stop()
    got = np.asarray([a["logits"] for a in answers], np.float32)

    mean, std = FASHION_STATS
    x = ((images.astype(np.float32) - mean) / std)[..., None]
    variables = v
    if packed:
        variables = {**v, "packed": jax_export_packed_collection(
            v["params"], v["quant"])}
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert [a["class"] for a in answers] == list(np.argmax(want, axis=1))
    assert stats["requests"] == N_REQUESTS
    assert stats["primary_failures"] == 0 and stats["fallback_batches"] == 0
    assert info["packed"] == packed and info["device"] == "cpu"


def test_synthetic_test_set_matches_jax():
    imgs, labels = synthetic_test_set("fashion_mnist", 50)
    _, _, j_imgs, j_labels = _synthetic("fashion_mnist", n_train=1,
                                        n_test=50)
    np.testing.assert_array_equal(imgs, j_imgs)
    np.testing.assert_array_equal(labels, j_labels)


def test_unported_options_and_grad_mode_mismatch_exit(checkpoint):
    _, _, path = checkpoint
    base = ["--checkpoint", path, "--device", "cpu"]
    with pytest.raises(SystemExit, match="not ported"):
        build_server(["--task", "retrieval", "--aot", "x"] + base)
    with pytest.raises(SystemExit, match="vocab.json"):  # none beside it
        build_server(["--task", "retrieval"] + base)
    with pytest.raises(SystemExit, match="not ported"):
        build_server(["--task", "classification", "--aot", "x"] + base)
    assert resolve_grad_mode("auto", {"l": {"wp": 1, "wn": 1}}) == "ttq"
    assert resolve_grad_mode("auto", {"l": {"alpha": 1}}) == "parity"
    with pytest.raises(SystemExit):
        resolve_grad_mode("parity", {"l": {"wp": 1, "wn": 1}})
    with pytest.raises(SystemExit):
        resolve_grad_mode("ttq", {"l": {"alpha": 1}})
