"""The port's EmbeddingIndex (serve/index.py) and search routes against
atq_tpu's on the CPU: the same adds and queries give the same ids, with
scores within 1e-5 (float32 corpus) and 1e-3 (int8 corpus; both sides
score bf16-rounded queries against the int8 rows with float32 sums, in
another order)."""

import numpy as np
import pytest

from atq_tpu.serve.http import make_search_routes as jax_search_routes
from atq_tpu.serve.index import EmbeddingIndex as JaxIndex
from atq_tpu_torch.serve.http import make_search_routes
from atq_tpu_torch.serve.index import EmbeddingIndex

DIM = 16


def _unit(rng, n):
    e = rng.randn(n, DIM).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


@pytest.mark.parametrize("quantize,atol", [("none", 1e-5), ("int8", 1e-3)])
def test_add_grow_search_match_jax(quantize, atol):
    rng = np.random.RandomState(0)
    port = EmbeddingIndex(DIM, capacity=4, quantize=quantize, device="cpu")
    ref = JaxIndex(DIM, capacity=4, quantize=quantize)
    for n in (3, 2, 9, 1):  # crosses the 4 -> 8 -> 16 tiers
        embs = _unit(rng, n)
        ids = [f"i{len(port) + j}" for j in range(n)]
        assert port.add(ids, embs) == ref.add(ids, embs)
        assert port.capacity == ref.capacity
        queries = _unit(rng, 3)
        for k in (1, 4, 100):
            got_ids, got = port.search(queries, k=k)
            want_ids, want = ref.search(queries, k=k)
            assert got_ids == want_ids
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=atol)
    assert port.capacity == 16 and len(port) == 15
    one_ids, one = port.search(queries[0], k=2)  # a 1-D query squeezes
    assert isinstance(one_ids[0], str) and one.shape == (2,)


def test_save_load_and_normalize_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    port = EmbeddingIndex(DIM, device="cpu")
    raw = rng.randn(5, DIM).astype(np.float32) * 3
    port.add([f"d{i}" for i in range(5)], raw, normalize=True)
    np.testing.assert_allclose(np.linalg.norm(port._embs[:5], axis=1), 1.0,
                               rtol=1e-6)
    path = str(tmp_path / "index.npz")
    port.save(path)
    ref = JaxIndex.load(path, quantize="int8")
    back = EmbeddingIndex.load(path, quantize="int8", device="cpu")
    q = rng.randn(2, DIM).astype(np.float32)
    got_ids, got = back.search(q, k=3, normalize=True)
    want_ids, want = ref.search(q, k=3, normalize=True)
    assert got_ids == want_ids
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-3)
    jax_path = str(tmp_path / "jax_index.npz")
    ref.save(jax_path)
    assert EmbeddingIndex.load(jax_path, device="cpu")._ids == ref._ids


def test_empty_index_and_bad_shapes_raise():
    index = EmbeddingIndex(DIM, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        index.search(np.zeros(DIM, np.float32))
    with pytest.raises(ValueError):
        index.add(["a"], np.zeros((1, DIM + 1), np.float32))
    index.add("a", np.ones(DIM, np.float32))
    with pytest.raises(ValueError):
        index.search(np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(ValueError):
        EmbeddingIndex(DIM, quantize="int4", device="cpu")


def test_search_routes_over_fake_embedders_match_jax():
    """/index/add and /search on both packages over the same fake embed
    routes (a deterministic embedding per token list or image)."""
    def fake_routes():
        def emb(seed):
            v = np.random.RandomState(seed).randn(DIM).astype(np.float32)
            return (v / np.linalg.norm(v)).tolist()

        return {"/embed_image": lambda p: {"embedding": emb(
                    int(np.sum(p["image"])) % 1000)},
                "/embed_text": lambda p: {"embedding": emb(
                    sum(p.get("tokens", [7])))}}

    answers = []
    for routes, index in (
            (make_search_routes, EmbeddingIndex(DIM, device="cpu")),
            (jax_search_routes, JaxIndex(DIM))):
        r = routes(index, fake_routes())
        for i in range(6):
            assert r["/index/add"]({"id": f"t{i}", "tokens": [i, i]})[
                "count"] == i + 1
        r["/index/add"]({"id": "img", "image": np.ones((2, 2, 3)).tolist()})
        with pytest.raises(ValueError):
            r["/index/add"]({"tokens": [1]})  # no id
        answers.append(r["/search"]({"tokens": [2, 2], "k": 3}))
    got, want = answers
    assert [x["id"] for x in got["results"]] == \
        [x["id"] for x in want["results"]]
    np.testing.assert_allclose([x["score"] for x in got["results"]],
                               [x["score"] for x in want["results"]],
                               rtol=0, atol=1e-5)
    assert got["count"] == want["count"] == 7
