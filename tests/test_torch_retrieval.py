"""The port's retrieval model (models/retrieval.py, text_encoder.py) and
retrieval server (``python -m atq_tpu_torch.serve --task retrieval``)
against atq_tpu's ``ATQMultimodalRetrieval`` on the CPU.

One JAX model at a small size (images 32x32, embed 32, FFN 64, 4 text
layers, sequence 12, a vocabulary of the synthetic corpus, batch 3) is
initialised once, its BatchNorm statistics drawn, and written with the JAX
trainer's ``.npz`` writer and a vocab.json beside it. The port loads it
through utils/jax_interop.py and must match ``model.apply`` within 1e-4:
dense, packed from uint8 planes, packed from planar32 words
(``ATQ_PACK32=1``) and with dense corrections, each with the int8 trunk
(the JAX side gets the same 'packed' and 'int8' collections), and with
padded lengths (the double softmax). The server runs over real HTTP.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.data.flickr8k import _synthetic_corpus
from atq_tpu.models.retrieval import (
    ATQMultimodalRetrieval as JaxRetrieval,
    get_model_size_info as jax_model_size_info,
)
from atq_tpu.nn.transformer import (
    normalize_checkpoint as jax_normalize_checkpoint,
    stack_layer_params,
)
from atq_tpu.serve.int8_trunk import export_int8_collection as jax_int8
from atq_tpu.serve.packed_model import (
    export_packed_collection as jax_export_packed,
)
from atq_tpu.train.classifier import _save_checkpoint
from atq_tpu_torch.data.flickr8k import save_vocab_file, synthetic_vocabulary
from atq_tpu_torch.models.retrieval import (
    ATQMultimodalRetrieval,
    get_model_size_info,
)
from atq_tpu_torch.nn.transformer import (
    is_scanned_text_layout,
    normalize_checkpoint,
)
from atq_tpu_torch.serve.__main__ import build_server
from atq_tpu_torch.serve.http import start_in_thread
from atq_tpu_torch.serve.int8_trunk import (
    attach_int8_collection,
    export_int8_collection,
)
from atq_tpu_torch.serve.packed_model import (
    attach_packed_collection,
    export_packed_collection,
)
from atq_tpu_torch.utils.jax_interop import load_checkpoint

EMBED, HIDDEN, SEQ, SIZE, BATCH = 32, 64, 12, 32, 3
TOL = 1e-4


def _draw_stats(tree, rng):
    if isinstance(tree, dict):
        return {k: (_draw_stats(v, rng) if isinstance(v, dict) else
                    (rng.randn(*v.shape) * 0.1 if k == "mean" else
                     rng.uniform(0.5, 1.5, v.shape)).astype(np.float32))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    names, captions, _ = _synthetic_corpus(400)
    vocab = synthetic_vocabulary([c for n in names[:320]
                                  for c in captions[n]])
    model = JaxRetrieval(vocab_size=len(vocab), embed_dim=EMBED,
                         hidden_dim=HIDDEN, max_seq_length=SEQ,
                         use_residual=True)
    rng = np.random.RandomState(0)
    images = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    tokens = rng.randint(4, len(vocab), (BATCH, SEQ)).astype(np.int32)
    lengths = np.asarray([SEQ, 5, 1], np.int32)  # padded rows: 2nd, 3rd
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros(
        (1, SIZE, SIZE, 3)), jnp.zeros((1, SEQ), jnp.int32),
        jnp.asarray([5], jnp.int32))
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"] = _draw_stats(v["batch_stats"], rng)
    d = tmp_path_factory.mktemp("retrieval")
    path = str(d / "best_model.npz")
    _save_checkpoint(v, path)
    save_vocab_file(vocab, str(d / "vocab.json"))
    enc_img = jax.jit(lambda var, im: model.apply(
        var, im, method=JaxRetrieval.encode_image))
    enc_txt = jax.jit(lambda var, t, n: model.apply(
        var, t, n, method=JaxRetrieval.encode_text))
    return {"model": model, "v": v, "vocab": vocab, "path": path,
            "images": images, "tokens": tokens, "lengths": lengths,
            "enc_img": enc_img, "enc_txt": enc_txt}


def _port_model(s, device="cpu"):
    m = ATQMultimodalRetrieval(vocab_size=len(s["vocab"]), embed_dim=EMBED,
                               hidden_dim=HIDDEN, max_seq_length=SEQ,
                               use_residual=True, device=device)
    m.load_jax_variables(load_checkpoint(s["path"]))
    return m


def _no_fusion(params):
    return {k: v for k, v in params.items() if k != "fusion"}


# (variant, ATQ_PACK32, sparse correction); None = dense, no int8 trunk.
VARIANTS = [("dense", None, None), ("packed", "0", True),
            ("packed32", "1", True), ("dense_correction", "0", False)]


@pytest.mark.parametrize("variant,pack32,sparse", VARIANTS,
                         ids=[v[0] for v in VARIANTS])
def test_encoders_match_jax(setup, monkeypatch, variant, pack32, sparse):
    s, v = setup, setup["v"]
    port = _port_model(s)
    jv = v
    if pack32 is not None:
        monkeypatch.setenv("ATQ_PACK32", pack32)
        jv = {**v, "packed": jax_export_packed(
                  v["params"], v["quant"], sparse_correction=sparse),
              "int8": jax_int8(v["params"], v["batch_stats"])}
        attach_packed_collection(port, export_packed_collection(
            _no_fusion(v["params"]), v["quant"], device="cpu",
            sparse_correction=sparse))
        attach_int8_collection(port, export_int8_collection(
            v["params"], v["batch_stats"], device="cpu"))
    want_img = np.asarray(s["enc_img"](jv, jnp.asarray(s["images"])))
    want_txt = np.asarray(s["enc_txt"](jv, jnp.asarray(s["tokens"]),
                                       jnp.asarray(s["lengths"])))
    with torch.no_grad():
        got_img = port.encode_image(torch.from_numpy(s["images"])).numpy()
        got_txt = port.encode_text(
            torch.from_numpy(s["tokens"]).long(),
            torch.from_numpy(s["lengths"]).long()).numpy()
    np.testing.assert_allclose(got_img, want_img, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_txt, want_txt, rtol=TOL, atol=TOL)


def test_similarity_and_embeddings_modes_match_jax(setup):
    s, v = setup, setup["v"]
    port = _port_model(s)
    args = (jnp.asarray(s["images"]), jnp.asarray(s["tokens"]),
            jnp.asarray(s["lengths"]))
    want_sim = np.asarray(jax.jit(s["model"].apply)(v, *args))
    # return_embeddings is (encode_image, encode_text).
    want_img, want_txt = s["enc_img"](v, args[0]), s["enc_txt"](v, *args[1:])
    targs = (torch.from_numpy(s["images"]),
             torch.from_numpy(s["tokens"]).long(),
             torch.from_numpy(s["lengths"]).long())
    with torch.no_grad():
        got_sim = port(*targs).numpy()
        got_img, got_txt = port(*targs, return_embeddings=True)
    np.testing.assert_allclose(got_sim, want_sim, rtol=TOL, atol=1e-3)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt),
                               rtol=TOL, atol=TOL)
    # return_fused runs the ported fusion (tests/test_torch_fusion.py).
    want_fused = np.asarray(jax.jit(lambda var, *a: s["model"].apply(
        var, *a, return_fused=True))(v, *args))
    with torch.no_grad():
        got_fused = port(*targs, return_fused=True).numpy()
    np.testing.assert_allclose(got_fused, want_fused, rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError):
        ATQMultimodalRetrieval(vocab_size=10, embed_dim=EMBED,
                               hidden_dim=HIDDEN, text_moe_experts=2,
                               device="cpu")


def test_interop_round_trip_keeps_every_collection(setup):
    """load_jax_variables then jax_variables gives back the checkpoint's
    params (fusion subtree included), quant, batch_stats and constants."""
    v = setup["v"]
    back = _port_model(setup).jax_variables()
    assert sorted(back) == sorted(v)

    def same(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)

    same(back, v, "")
    assert get_model_size_info(v["params"]) == jax_model_size_info(
        v["params"])


def test_scanned_checkpoint_normalizes_like_jax(setup):
    v = setup["v"]
    te_p, te_q = v["params"]["text_encoder"], v["quant"]["text_encoder"]
    scanned = {**v,
               "params": {**v["params"], "text_encoder": stack_layer_params(
                   te_p, 4)},
               "quant": {**v["quant"], "text_encoder": stack_layer_params(
                   te_q, 4)}}
    scanned = jax.tree_util.tree_map(np.asarray, scanned)
    assert is_scanned_text_layout(scanned["params"]["text_encoder"])
    got, was = normalize_checkpoint(scanned)
    want, jax_was = jax_normalize_checkpoint(scanned, verbose=False)
    assert was and jax_was
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (p, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), str(p))
    assert normalize_checkpoint(v) == (v, False)  # unrolled: untouched


def _post(port, route, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                timeout=60) as r:
        return json.loads(r.read())


SERVER_CASES = {"packed_int8": ["--packed"], "dense": ["--no_int8_trunk"]}


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_http_server_matches_jax(setup, case):
    """/embed_image (one request at a time: the int8 trunk's activation
    scale is one per batch), /embed_text with ``text`` and with ``tokens``,
    /index/add, /search and /healthz on ``--device cpu``."""
    from atq_tpu.data.flickr8k import END, START, clean_caption, tokenize

    s, v = setup, setup["v"]
    argv = ["--task", "retrieval", "--checkpoint", s["path"],
            "--use_residual", "--embed_dim", str(EMBED), "--hidden_dim",
            str(HIDDEN), "--max_seq_length", str(SEQ), "--image_size",
            str(SIZE), "--port", "0", "--device", "cpu"] + SERVER_CASES[case]
    jv = v
    if case == "packed_int8":
        jv = {**v, "packed": jax_export_packed(v["params"], v["quant"]),
              "int8": jax_int8(v["params"], v["batch_stats"])}
    httpd, servers, info = build_server(argv)
    start_in_thread(httpd)
    texts = ["a dog runs on the beach", "two men climb in the snow"]
    try:
        port = info["port"]
        img = [_post(port, "/embed_image", {"image": im.tolist()})[
            "embedding"] for im in s["images"]]
        by_text = [_post(port, "/embed_text", {"text": t}) for t in texts]
        by_tokens = _post(port, "/embed_text",
                          {"tokens": s["tokens"][1, :5].tolist()})
        for i in range(BATCH):
            assert _post(port, "/index/add", {"id": f"img{i}",
                                              "image": s["images"][i]
                                              .tolist()})["count"] == i + 1
        for i, t in enumerate(texts):
            _post(port, "/index/add", {"id": f"txt{i}", "text": t})
        found = _post(port, "/search", {"text": texts[1], "k": 3})
        health = _get(port, "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        for srv in servers:
            srv.stop()

    want_img = np.concatenate([np.asarray(s["enc_img"](
        jv, jnp.asarray(im[None]))) for im in s["images"]])
    np.testing.assert_allclose(np.asarray(img), want_img, rtol=TOL, atol=TOL)
    ids = np.zeros((len(texts) + 1, SEQ), np.int32)
    lengths = []
    for i, t in enumerate(texts):
        row = [START] + [s["vocab"].get(w, 1) for w in tokenize(
            clean_caption(t))] + [END]
        ids[i, :len(row)] = row
        lengths.append(len(row))
    ids[-1, :5] = s["tokens"][1, :5]
    lengths.append(5)
    want_txt = np.asarray(s["enc_txt"](jv, jnp.asarray(ids),
                                       jnp.asarray(lengths, np.int32)))
    got_txt = np.asarray([a["embedding"] for a in by_text]
                         + [by_tokens["embedding"]])
    np.testing.assert_allclose(got_txt, want_txt, rtol=TOL, atol=TOL)
    assert [a["length"] for a in by_text] + [by_tokens["length"]] == lengths
    corpus = np.concatenate([want_img, want_txt[:2]])
    order = np.argsort(-(corpus @ want_txt[1]))[:3]
    names = [f"img{i}" for i in range(BATCH)] + ["txt0", "txt1"]
    assert [r["id"] for r in found["results"]] == [names[j] for j in order]
    assert found["results"][0]["id"] == "txt1" and found["count"] == 5
    assert health["ok"] and set(health["stats"]) == {"server_0", "server_1"}
    assert sorted(info["routes"]) == ["/embed_image", "/embed_text",
                                      "/index/add", "/search"]
    assert info["packed"] == (case == "packed_int8")
