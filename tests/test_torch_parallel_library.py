"""The port's parallel library in a gloo world of 2 on the CPU
(tests/_torch_dist.py ``library_checks``, one launch), against the
one-process port and JAX's functions on 2 of the conftest's virtual CPU
devices:

- collectives and per-process input (tests/test_parallel.py's and
  tests/test_multihost.py's cases): the differentiable all-gather of the
  negative pool (its backward the sum over the ranks), ``psum_grads``,
  ``pmean_metrics``, the global similarity, ``process_batch_slice``
  (raising on an uneven batch), ``global_batch_from_local``,
  ``shard_batch`` and ``replicate``;
- ``moe_ffn_sharded`` (8 ternary experts, 4 a rank, a capacity that
  overflows, padding tokens): each rank's output, aux statistics and
  gradients (its tokens', the gate's summed over the ranks, its experts')
  against ``moe_ffn`` on each token shard in one process and against
  JAX's ``moe_ffn_sharded`` (its ``jax.grad``), within 1e-5;
- the row-sharded index search, float32 and int8: the same ids as the
  one-process search and JAX's sharded search, scores within 1e-6;
- ring attention with a padding mask and ``sequence_parallel_attention``:
  outputs and each block's gradients against dense attention and JAX's
  within 1e-5;
- the GPipe pipeline, 2 stages and 4 microbatches: output and each
  stage's gradients against the stages applied in order and JAX's
  ``pipeline_apply`` within 1e-5;
- the retrieval trainer's ``main`` on two ranks, as torchrun starts them
  (``--dp 2 --fsdp --use_ema``): the ranks report the same losses, rank 0
  alone writes the artifacts (one metrics line an epoch), and the whole
  checkpoint loads in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _torch_dist as td
from atq_tpu.parallel import moe as jmoe
from atq_tpu.parallel.mesh import make_mesh as jax_make_mesh
from atq_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from atq_tpu.parallel.ring_attention import (
    sequence_parallel_attention as jax_seq_attention,
)
from atq_tpu.serve.index import EmbeddingIndex as JaxIndex
from atq_tpu_torch.parallel.moe import moe_ffn
from atq_tpu_torch.parallel.ring_attention import dense_reference_attention
from atq_tpu_torch.serve.index import EmbeddingIndex

N = 2
T, D, H, E, CAP = 24, 8, 12, 8, 2  # 12 tokens a rank, 2 slots an expert
B, HEADS, L, DH = 2, 2, 8, 4


def _data():
    rng = np.random.RandomState(0)
    f = np.float32
    corpus = rng.randn(37, 16).astype(f)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    pad = np.zeros((B, L), bool)
    pad[0, -3:] = True
    return {
        "emb": rng.randn(8, 4).astype(f), "emb2": rng.randn(8, 4).astype(f),
        "emb_g": rng.randn(8, 4).astype(f),
        "moe_x": rng.randn(T, D).astype(f), "moe_g": rng.randn(T, D).astype(f),
        "moe_gate": (rng.randn(D, E) * D ** -0.5).astype(f),
        "moe_w1": (rng.randn(E, D, H) * D ** -0.5).astype(f),
        "moe_w2": (rng.randn(E, H, D) * H ** -0.5).astype(f),
        "moe_mask": np.arange(T) % 7 != 3, "moe_capacity": CAP,
        "moe_ternary": True,
        "corpus": corpus, "capacity": 64, "topk": 5,
        "queries": rng.randn(3, 16).astype(f),
        "q": rng.randn(B, HEADS, L, DH).astype(f),
        "k": rng.randn(B, HEADS, L, DH).astype(f),
        "v": rng.randn(B, HEADS, L, DH).astype(f), "pad": pad,
        "attn_g": rng.randn(B, HEADS, L, DH).astype(f),
        "pw": (rng.randn(N, 6, 6) * 0.5).astype(f),
        "pb": (rng.randn(N, 6) * 0.1).astype(f),
        "px": rng.randn(8, 6).astype(f), "pg": rng.randn(8, 6).astype(f),
        "n_micro": 4,
    }


@pytest.fixture(scope="module")
def run():
    data = _data()
    return data, td.launch(N, td.library_checks, data)


def _rows(a, r, n=N):
    per = a.shape[0] // n
    return a[r * per:(r + 1) * per]


def test_collectives_and_per_process_input(run):
    data, ranks = run
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["gathered"], data["emb"])
        np.testing.assert_allclose(out["gathered_grad"],
                                   N * _rows(data["emb_g"], r), rtol=1e-6)
        np.testing.assert_array_equal(out["psum"]["a"], np.full(3, 3.0))
        np.testing.assert_array_equal(out["psum"]["b"], np.ones(2))
        assert float(out["pmean"]["loss"]) == 0.5
        np.testing.assert_allclose(out["similarity"],
                                   data["emb"] @ data["emb2"].T / 0.07,
                                   rtol=1e-5, atol=1e-5)
        assert tuple(out["slice"]) == (4 * r, 4 * r + 4)
        assert out["uneven_raises"]
        np.testing.assert_array_equal(out["global_batch"], data["emb"])
        np.testing.assert_array_equal(out["shard_batch"],
                                      _rows(data["emb"], r))
        np.testing.assert_array_equal(out["replicate"], np.zeros(2))


def _moe_reference(data):
    """``moe_ffn`` on each rank's token shard in one process, with the
    objective each rank adds up (its outputs against its cotangent, plus
    the aux loss): the sum over the shards."""
    t = {k: torch.from_numpy(data[k]).clone().requires_grad_()
         for k in ("moe_x", "moe_gate", "moe_w1", "moe_w2")}
    params = {"gate": t["moe_gate"], "w1": t["moe_w1"], "w2": t["moe_w2"]}
    ys, auxes, total = [], [], 0.0
    for r in range(N):
        y, aux = moe_ffn(_rows(t["moe_x"], r), params, CAP, ternary=True,
                         token_mask=torch.from_numpy(_rows(data["moe_mask"],
                                                           r)))
        total = total + (y * torch.from_numpy(_rows(data["moe_g"], r))).sum()
        total = total + aux["aux_loss"]
        ys.append(y.detach().numpy())
        auxes.append({k: v.detach().numpy() for k, v in aux.items()})
    total.backward()
    return ys, auxes, {k: v.grad.numpy() for k, v in t.items()}


def _moe_jax(data):
    mesh = Mesh(np.asarray(jax.devices()[:N]), axis_names=("expert",))
    params = {"gate": data["moe_gate"], "w1": data["moe_w1"],
              "w2": data["moe_w2"]}
    mask = jnp.asarray(data["moe_mask"])

    def objective(p, x):
        y, aux = jmoe.moe_ffn_sharded(x, p, mesh, CAP, ternary=True,
                                      token_mask=mask)
        return jnp.sum(y * data["moe_g"]) + N * aux["aux_loss"], (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params,
                                                  jnp.asarray(data["moe_x"]))
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, aux), grads


def test_moe_ffn_sharded_matches_one_process_and_jax(run):
    data, ranks = run
    ys, auxes, grads = _moe_reference(data)
    jy, jaux, (jp, jx) = _moe_jax(data)
    tol = dict(rtol=1e-5, atol=1e-5)
    assert max(np.abs(a["expert_fraction"]).max() for a in auxes) > 0.3
    dgate = sum(out["moe"]["dgate"] for out in ranks)
    for r, out in enumerate(ranks):
        m = out["moe"]
        np.testing.assert_allclose(m["y"], ys[r], **tol)
        np.testing.assert_allclose(m["y"], _rows(jy, r), **tol)
        for key in ("aux_loss", "expert_fraction"):
            mean = np.mean([a[key] for a in auxes], axis=0)
            np.testing.assert_allclose(m["aux"][key], mean, **tol)
            np.testing.assert_allclose(m["aux"][key], jaux[key], **tol)
        np.testing.assert_allclose(m["dx"], _rows(grads["moe_x"], r), **tol)
        np.testing.assert_allclose(m["dx"], _rows(np.asarray(jx), r), **tol)
        for name in ("w1", "w2"):
            want = _rows(grads["moe_" + name], r)
            np.testing.assert_allclose(m["d" + name], want, **tol)
            np.testing.assert_allclose(m["d" + name],
                                       _rows(np.asarray(jp[name]), r), **tol)
    np.testing.assert_allclose(dgate, grads["moe_gate"], **tol)
    np.testing.assert_allclose(dgate, np.asarray(jp["gate"]), **tol)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_sharded_search_matches_one_process_and_jax(run, quantize):
    data, ranks = run
    ids = [f"c{i}" for i in range(len(data["corpus"]))]
    one = EmbeddingIndex(dim=16, capacity=data["capacity"],
                         quantize=quantize, device="cpu")
    one.add(ids, data["corpus"])
    want_ids, want = one.search(data["queries"], k=data["topk"])
    jindex = JaxIndex(dim=16, capacity=data["capacity"], quantize=quantize)
    jindex.add(ids, data["corpus"])
    jids, jscores = jindex.search(data["queries"], k=data["topk"],
                                  mesh=jax_make_mesh(
                                      dp=N, devices=jax.devices()[:N]))
    for out in ranks:
        got_ids, got = out["search_" + quantize]
        assert got_ids == want_ids == jids
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, jscores, rtol=1e-6, atol=1e-6)


def _attention_reference(data):
    t = {k: torch.from_numpy(data[k]).clone().requires_grad_()
         for k in ("q", "k", "v")}
    o = dense_reference_attention(t["q"], t["k"], t["v"],
                                  torch.from_numpy(data["pad"]))
    (o * torch.from_numpy(data["attn_g"])).sum().backward()
    return o.detach().numpy(), {k: v.grad.numpy() for k, v in t.items()}


def _attention_jax(data):
    mesh = jax_make_mesh(dp=N, devices=jax.devices()[:N])

    def objective(q, k, v):
        o = jax_seq_attention(q, k, v, mesh, key_padding_mask=jnp.asarray(
            data["pad"]))
        return jnp.sum(o * data["attn_g"]), o

    (_, o), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(data[k]) for k in ("q", "k", "v")))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _block(a, r):
    per = a.shape[2] // N
    return a[:, :, r * per:(r + 1) * per]


def test_ring_attention_matches_dense_and_jax(run):
    data, ranks = run
    o, grads = _attention_reference(data)
    jo, jgrads = _attention_jax(data)
    tol = dict(rtol=1e-5, atol=1e-5)
    for r, out in enumerate(ranks):
        ring = out["ring"]
        np.testing.assert_allclose(ring["o"], _block(o, r), **tol)
        np.testing.assert_allclose(ring["o"], _block(jo, r), **tol)
        for name, jg in zip(("q", "k", "v"), jgrads):
            np.testing.assert_allclose(ring["d" + name],
                                       _block(grads[name], r), **tol)
            np.testing.assert_allclose(ring["d" + name], _block(jg, r),
                                       **tol)
        np.testing.assert_allclose(out["seq_parallel"], o, **tol)
        np.testing.assert_allclose(out["seq_parallel"], jo, **tol)


def test_pipeline_matches_sequential_and_jax(run):
    data, ranks = run
    w = torch.from_numpy(data["pw"]).clone().requires_grad_()
    b = torch.from_numpy(data["pb"]).clone().requires_grad_()
    h = torch.from_numpy(data["px"])
    for s in range(N):
        h = torch.tanh(h @ w[s] + b[s])
    (h * torch.from_numpy(data["pg"])).sum().backward()
    mesh = Mesh(np.asarray(jax.devices()[:N]), axis_names=("pipe",))

    def objective(p):
        y = jax_pipeline(lambda q, x: jnp.tanh(x @ q["pw"] + q["pb"]), p,
                         jnp.asarray(data["px"]), mesh=mesh,
                         n_micro=data["n_micro"])
        return jnp.sum(y * data["pg"]), y

    (_, jy), jg = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        {"pw": jnp.asarray(data["pw"]), "pb": jnp.asarray(data["pb"])})
    tol = dict(rtol=1e-5, atol=1e-6)
    for r, out in enumerate(ranks):
        p = out["pipeline"]
        np.testing.assert_allclose(p["y"], h.detach().numpy(), **tol)
        np.testing.assert_allclose(p["y"], np.asarray(jy), **tol)
        np.testing.assert_allclose(p["dw"], w.grad[r].numpy(), **tol)
        np.testing.assert_allclose(p["db"], b.grad[r].numpy(), **tol)
        np.testing.assert_allclose(p["dw"], np.asarray(jg["pw"][r]), **tol)
        np.testing.assert_allclose(p["db"], np.asarray(jg["pb"][r]), **tol)


def test_retrieval_main_on_two_ranks(tmp_path):
    from atq_tpu.train.classifier import load_checkpoint as jax_load

    out = tmp_path / "retrieval"
    ranks = td.launch(N, td.trainer_main, "retrieval", [
        "--device", "cpu", "--dp", "2", "--fsdp", "--batch_size", "4",
        "--embed_dim", "32", "--hidden_dim", "64", "--image_size", "32",
        "--max_seq_length", "12", "--synthetic_images", "20", "--epochs",
        "1", "--use_residual", "--use_ema", "--output_dir", str(out),
        "--data_dir", str(tmp_path / "no_flickr8k")])
    assert ranks[0] == ranks[1] and np.isfinite(ranks[0]).all()
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 1
    ckpt = jax_load(str(out / "final_model.npz"))
    assert ckpt["params"]["image_encoder"]["base_model"]["conv1"][
        "kernel"].shape == (7, 7, 3, 64)
    assert (out / "checkpoint_epoch_1.npz").exists()
