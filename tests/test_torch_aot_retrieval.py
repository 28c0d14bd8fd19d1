"""``python -m atq_tpu_torch.serve --task retrieval --packed --aot`` on the
CPU: export, then load, against the live port bit for bit and against
JAX's ``serve.py --aot`` within 1e-4 (tests/test_torch_retrieval.py's
tolerance), and the exported graphs' kernels.

The model is written by the port (a seeded init, JAX's ``.npz`` layout,
as ``chip_smoke.py`` writes it) at widths where every ternary layer is
kernel-eligible (K >= 128, N >= 8) but one: embed 128, FFN 128, 4 text layers,
sequence 12, images 32x32. Both CLIs serve it with the int8 trunk (their
default) and 2-bit planes. Each program must hold one
``atq_tpu_torch::ternary_matmul`` for each packed layer its live forward
runs at a kernel-eligible shape, and no decode by shifts or sort in their
place (the text tower's last pooling layer, 128 -> 64 at these widths,
is below the kernel and decodes, as in the JAX package).
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from atq_tpu_torch.data.flickr8k import (
    _synthetic_corpus,
    save_vocab_file,
    synthetic_vocabulary,
)
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.serve.__main__ import (
    build_parser,
    build_retrieval,
    build_retrieval_routes,
)
from atq_tpu_torch.serve.aot import AOTServing
from atq_tpu_torch.utils.jax_interop import load_checkpoint, save_checkpoint

EMBED, HIDDEN, SEQ, SIZE = 128, 128, 12, 32
TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    torch.set_num_threads(1)
    names, captions, _ = _synthetic_corpus(400)
    vocab = synthetic_vocabulary([c for n in names[:320]
                                  for c in captions[n]])
    model = ATQMultimodalRetrieval(
        vocab_size=len(vocab), embed_dim=EMBED, hidden_dim=HIDDEN,
        max_seq_length=SEQ, use_residual=True, device="cpu",
        generator=torch.Generator().manual_seed(0))
    d = tmp_path_factory.mktemp("retrieval")
    path = str(d / "best_model.npz")
    save_checkpoint(model.jax_variables(), path)
    save_vocab_file(vocab, str(d / "vocab.json"))
    return path, vocab


def _argv(path, *extra):
    return ["--task", "retrieval", "--checkpoint", path, "--use_residual",
            "--packed", "--embed_dim", str(EMBED), "--hidden_dim",
            str(HIDDEN), "--max_seq_length", str(SEQ), "--image_size",
            str(SIZE), "--max_wait_ms", "1", *extra]


def _embeds(routes, image, text):
    return (routes["/embed_image"](image)["embedding"],
            routes["/embed_text"](text)["embedding"])


def _packed_layers_run(model, fn, *args):
    """``(eligible, below)``: how many packed layers ``fn`` runs at
    kernel-eligible shapes, and how many below them (which decode and
    matmul, as in the JAX package), by forward hooks."""
    from atq_tpu_torch.ops.ternary_matmul import kernel_eligible

    calls = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: calls.append(kernel_eligible(
            (1, mod.packed_entry["shape"][1]), mod.packed_entry["shape"])))
        for m in model.modules()
        if getattr(m, "packed_entry", None) is not None]
    try:
        with torch.inference_mode():
            fn(*args)
    finally:
        for h in hooks:
            h.remove()
    return sum(calls), len(calls) - sum(calls)


def test_serve_cli_aot_retrieval(checkpoint, tmp_path, capsys):
    import serve as jax_serve
    from atq_tpu.train.classifier import load_checkpoint as jax_load

    torch.set_num_threads(1)
    path, vocab = checkpoint
    rng = np.random.RandomState(1)
    image = {"image": rng.rand(SIZE, SIZE, 3).tolist(), "normalize": True}
    text = {"text": "a dog runs on the grass"}
    args = build_parser().parse_args(
        _argv(path, "--aot", str(tmp_path / "aot"), "--device", "cpu"))
    ckpt = load_checkpoint(path)
    answers = {}
    for run in ("exported", "loaded", "live"):
        if run == "live":
            args.aot = None
        routes, servers = build_retrieval_routes(args, ckpt, "parity", CPU)
        try:
            answers[run] = _embeds(routes, image, text)
        finally:
            for s in servers:
                s.stop()
    lines = [json.loads(line) for line in capsys.readouterr().out.split("\n")
             if line.startswith('{"aot"')]
    assert [x["aot"] for x in lines] == ["exported"] * 2 + ["loaded"] * 2
    assert all(x["batch_polymorphic"] for x in lines)
    for run in ("exported", "loaded"):
        assert answers[run] == answers["live"]

    jax_args = jax_serve.build_parser().parse_args(
        _argv(path, "--aot", str(tmp_path / "jax")))
    routes, servers = jax_serve.build_retrieval_routes(
        jax_args, jax_load(path), "parity")
    try:
        want = _embeds(routes, image, text)
    finally:
        for s in servers:
            s.stop()
    assert os.path.exists(tmp_path / "jax" / "embed_text" / "manifest.json")
    for got, w in zip(answers["loaded"], want):
        np.testing.assert_allclose(got, w, rtol=0, atol=TOL)

    model = build_retrieval(args, ckpt, "parity", CPU, len(vocab))
    tokens = torch.zeros((2, SEQ), dtype=torch.int64)
    reached = {
        "embed_image": _packed_layers_run(model, model.encode_image,
                                          torch.zeros(2, SIZE, SIZE, 3)),
        "embed_text": _packed_layers_run(model, model.encode_text, tokens,
                                         torch.tensor([5, 5]))}
    assert reached["embed_image"][0] >= 1 and reached["embed_text"][0] >= 20
    for name, (eligible, below) in reached.items():
        (ep,) = AOTServing.load(str(tmp_path / "aot" / name)).programs \
            .values()
        ops = Counter(str(n.target) for n in ep.graph.nodes
                      if n.op == "call_function")
        kernels = {k: v for k, v in ops.items()
                   if k.startswith("atq_tpu_torch.")}
        assert kernels == {"atq_tpu_torch.ternary_matmul.default": eligible}
        # one shift a decode, only where a layer is below the kernel
        assert ops["aten.__rshift__.Tensor"] == below, name
        assert not [k for k in ops if "sort" in k], name
