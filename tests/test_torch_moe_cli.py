"""The three commands with ``--moe_experts`` on the CPU (``--device cpu``):

- ``python -m atq_tpu_torch.train.retrieval --moe_experts 2`` trains one
  epoch at a tiny size (embed 32, FFN 64, images 32x32, sequence 12, the
  20-image synthetic corpus): finite losses, and its ``final_model.npz``
  holds each text layer's ``moe_gate``, ``moe_w1`` and ``moe_w2`` (and no
  ``linear1``/``linear2``) under the JAX layout's names and shapes;
- ``python -m atq_tpu_torch.serve --task retrieval --moe_experts 2`` on
  that checkpoint, ``--packed`` and ``--packed --aot DIR`` (exported, then
  loaded): the ``--aot`` programs batch-polymorphic and bit for bit with
  the live packed server, which is within 2e-2 of the dense server (the
  packed layers' corrections are rounded to bf16); with the float trunk,
  within 1e-4 of JAX's ``serve.py --packed --moe_experts 2`` (the expert
  planes stay dense in both);
- ``--dp``, ``--tp`` and ``--fsdp`` still raise
  (tests/test_torch_retrieval_train.py).

``python -m atq_tpu_torch.evaluate --moe_experts`` is in
tests/test_torch_evaluate.py.
"""

import json

import numpy as np
import pytest
import torch

from atq_tpu_torch.serve.__main__ import build_parser, build_retrieval_routes
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import load_checkpoint

EMBED, HIDDEN, SEQ, SIZE, EXPERTS = 32, 64, 12, 32, 2
TOL = 1e-4
PACKED_ATOL = 2e-2  # packed against dense (chip_smoke.py's limit)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_cli")
    out = root / "run"
    state, history, _ = ptrain.main([
        "--device", "cpu", "--moe_experts", str(EXPERTS), "--batch_size",
        "4", "--embed_dim", str(EMBED), "--hidden_dim", str(HIDDEN),
        "--image_size", str(SIZE), "--max_seq_length", str(SEQ),
        "--synthetic_images", "20", "--epochs", "1", "--use_residual",
        "--reinit_model", "--output_dir", str(out), "--data_dir",
        str(root / "no_flickr8k")])
    # One epoch at this size may not beat R@1 = 0 and write
    # best_model.npz; final_model.npz is always written.
    return str(out / "final_model.npz"), state, history


def test_train_cli_writes_the_expert_leaves(trained):
    path, state, history = trained
    losses = [x for epoch in state["stats"]["step_losses"] for x in epoch]
    assert losses and np.isfinite(losses).all()
    assert np.isfinite(history["train_losses"]).all()
    layer = load_checkpoint(path)["params"]["text_encoder"]["layers_0"]
    assert {"moe_gate", "moe_w1", "moe_w2"} <= set(layer)
    assert not {"linear1", "linear2"} & set(layer)
    assert layer["moe_gate"].shape == (EMBED, EXPERTS)
    assert layer["moe_w1"].shape == (EXPERTS, EMBED, HIDDEN)
    assert layer["moe_w2"].shape == (EXPERTS, HIDDEN, EMBED)


def _argv(path, *extra):
    return ["--task", "retrieval", "--checkpoint", path, "--use_residual",
            "--moe_experts", str(EXPERTS), "--embed_dim", str(EMBED),
            "--hidden_dim", str(HIDDEN), "--max_seq_length", str(SEQ),
            "--image_size", str(SIZE), "--max_wait_ms", "1", *extra]


def _answers(path, *extra):
    args = build_parser().parse_args(_argv(path, *extra))
    rng = np.random.RandomState(1)
    image = {"image": rng.rand(SIZE, SIZE, 3).tolist(), "normalize": True}
    routes, servers = build_retrieval_routes(args, load_checkpoint(path),
                                             "parity", CPU)
    try:
        return [routes["/embed_image"](image)["embedding"]] + [
            routes["/embed_text"]({"text": t})["embedding"]
            for t in ("a dog runs on the grass", "two children play")]
    finally:
        for s in servers:
            s.stop()


def test_serve_cli_packed_and_aot(trained, tmp_path, capsys):
    import serve as jax_serve
    from atq_tpu.train.classifier import load_checkpoint as jax_load

    path = trained[0]
    dense = _answers(path, "--device", "cpu")
    packed = _answers(path, "--packed", "--device", "cpu")
    aot_dir = str(tmp_path / "aot")
    exported = _answers(path, "--packed", "--aot", aot_dir, "--device",
                        "cpu")
    loaded = _answers(path, "--packed", "--aot", aot_dir, "--device", "cpu")
    lines = [json.loads(line) for line in capsys.readouterr().out.split("\n")
             if line.startswith('{"aot"')]
    assert [x["aot"] for x in lines] == ["exported"] * 2 + ["loaded"] * 2
    assert all(x["batch_polymorphic"] for x in lines)
    assert exported == packed and loaded == packed
    for got, want in zip(packed, dense):  # bf16-rounded corrections
        np.testing.assert_allclose(got, want, rtol=0, atol=PACKED_ATOL)

    # The float trunk on both sides: here the image tower is not the MoE's
    # concern, and after training the int8 trunk's image embedding of one
    # image differs from JAX's by 1.3e-2 (ROADMAP.md queue 3).
    packed = _answers(path, "--packed", "--no_int8_trunk", "--device",
                      "cpu")
    jax_args = jax_serve.build_parser().parse_args(
        _argv(path, "--packed", "--no_int8_trunk"))
    routes, servers = jax_serve.build_retrieval_routes(
        jax_args, jax_load(path), "parity")
    try:
        rng = np.random.RandomState(1)
        image = {"image": rng.rand(SIZE, SIZE, 3).tolist(),
                 "normalize": True}
        want = [routes["/embed_image"](image)["embedding"]] + [
            routes["/embed_text"]({"text": t})["embedding"]
            for t in ("a dog runs on the grass", "two children play")]
    finally:
        for s in servers:
            s.stop()
    for got, w in zip(packed, want):
        np.testing.assert_allclose(got, w, rtol=0, atol=TOL)
