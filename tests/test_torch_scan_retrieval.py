"""The retrieval trainer's ``--scan_layers`` (the text tower as the
``ScannedTernaryStack``, ``layers.scan.layer.*``) against atq_tpu's
``text_scan_layers=True`` on the CPU, at the JAX package's small test size
(vocabulary 60, embed 32, FFN 64, images 32x32, batch 4, sequence 8):

- from one JAX init (dropout 0, float images: no random draw), the port's
  scanned model embeds as JAX's does (eval mode, within 1e-5), and one
  train step of the port's trainer, with and without
  ``--grad_checkpointing``, dense and under ATQ_FUSED=1 on both sides,
  and one of JAX's (whose checkpointed step
  tests/test_components.py:198 holds to its plain step) give the same
  loss (within 1e-5 relative)
  and, leaf by leaf, the same step-0 gradient (Adam's first moment after
  one step) within 5e-3 of the leaf's L2 norm (the unrolled trajectory's
  ``GRAD_RTOL`` in tests/test_torch_retrieval_train.py), every stacked
  leaf included; the leaves whose gradient is zero to rounding (at most
  1e-6 of the model's largest) are so on both sides;
- the port's scanned and unrolled models, on the same weights (mapped by
  ``stack_layer_params``), with dropout 0.1 and uint8 images (the flip
  on), dense and under ATQ_FUSED=1: loss, every gradient, the BatchNorm
  statistics and the generator's state equal bit for bit. Each scanned
  layer is rematerialized; its recompute replays the dropout generator
  (nn/transformer.py run_layer). Under ATQ_FUSED=1 every projection,
  stacked or not, calls the fused op, as JAX's scanned layers do;
- ``python -m atq_tpu_torch.train.retrieval --scan_layers`` writes a
  ``checkpoint_epoch_1.npz`` whose text tower is JAX's scanned layout
  (``layers/scan/layer/*``), and JAX's scanned model embeds from it what
  the port embeds (within 1e-5).

The readings behind the tolerances, at one torch thread, with and
without ``--grad_checkpointing``, dense and fused alike: loss 1.2e-6
relative, embeddings 3.5e-6,
gradients 1.15e-3 of the leaf's norm (the stacked k_proj alpha, a sum
over a whole layer; every other leaf 3.3e-4 or less, as the unrolled
model's step-0 gradients read 1.9e-3 at most there); the checkpoint's
embeddings on JAX 1.4e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atq_tpu.data import flickr8k as jax_f8k
from atq_tpu.losses.contrastive import (
    ContrastiveLearningManager as JaxManager,
    HardNegativeMiningInfoNCE as JaxInfoNCE,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.train import retrieval as jtrain
from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.nn.transformer import stack_layer_params
from atq_tpu_torch.ops import fused_linear
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import load_checkpoint

VOCAB, EMBED, HIDDEN, SIZE, BATCH, SEQ = 60, 32, 64, 32, 4, 8
LOSS_RTOL, EMBED_ATOL, GRAD_RTOL, ROUNDING = 1e-5, 1e-5, 5e-3, 1e-6
# The quantized layers on the embedding path: the text tower's 4 x 6
# projections and the two projectors' layers.
N_FUSED = 28
GC = pytest.mark.parametrize("remat", [False, True],
                             ids=["plain", "grad_checkpointing"])


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setattr(jax_f8k, "_USE_NLTK", False)
    monkeypatch.delenv("ATQ_SPLIT_TOKENIZER", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _batch(vocab=VOCAB):
    rng = np.random.RandomState(11)
    return (rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
            rng.randint(4, vocab, (BATCH, SEQ)).astype(np.int32),
            rng.randint(2, SEQ + 1, BATCH).astype(np.int32))


def _adam_mu(opt_state):
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_mu(part)
        if found is not None:
            return found
    return None


def _port_model(scanned, **kw):
    return ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, text_scan_layers=scanned,
        device="cpu", **kw)


CONFIG = dict(batch_size=BATCH, epochs=10, learning_rate=5e-5,
              contrastive_reg=0.05, scan_layers=True)


def _jax_step0_under(fused):
    """JAX's scanned model from its init: the variables, the eval-mode
    embeddings of ``_batch()``, and one train step's loss and Adam first
    moment, dense or under ATQ_FUSED=1 (the fused op's custom VJP, whose
    products off the TPU are its XLA reference). JAX's
    ``--grad_checkpointing`` is ``jax.checkpoint`` around the same forward
    (atq_tpu/train/retrieval.py:331-343), held to the plain step by
    tests/test_components.py:198, so one JAX step serves both of the
    port's."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ATQ_FUSED", "1" if fused else "0")
    try:
        return _jax_step0()
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_step0():
    return _jax_step0_under(False)


@pytest.fixture(scope="module")
def jax_fused_step0():
    return _jax_step0_under(True)


def _jax_step0():
    model = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, dropout=0.0,
                         text_scan_layers=True)
    jb = tuple(jnp.asarray(a) for a in _batch())
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(0), *jb))
    assert "scan" in v["params"]["text_encoder"]["layers"]
    jcfg = jtrain.RetrievalConfig(**CONFIG)
    tx = jtrain.make_retrieval_optimizer(jcfg, 6)
    crit = JaxInfoNCE(temperature=0.07, lambda_reg=0.05)
    step = jax.jit(jtrain.build_retrieval_train_step(
        model, tx, crit, JaxManager(criterion=crit), jcfg))
    state = {"params": v["params"], "quant": v["quant"],
             "constants": v["constants"], "batch_stats": v["batch_stats"],
             "opt_state": tx.init(v["params"]),
             "step": jnp.asarray(0, jnp.int32)}
    emb = [np.asarray(e) for e in model.apply(
        v, *jb, return_embeddings=True, train=False)]
    state, loss = step(state, jb, jnp.float32(0.14), jnp.int32(0),
                       jax.random.PRNGKey(1))
    return v, emb, float(loss), dict(_leaves(_np(_adam_mu(
        state["opt_state"]))))


@GC
def test_scanned_step0_matches_jax(jax_step0, remat, monkeypatch):
    monkeypatch.setenv("ATQ_FUSED", "0")
    _check_step0_against_jax(jax_step0, remat)


@GC
def test_scanned_fused_step0_matches_jax(jax_fused_step0, remat,
                                         monkeypatch):
    monkeypatch.setenv("ATQ_FUSED", "1")
    _check_step0_against_jax(jax_fused_step0, remat)


def _check_step0_against_jax(jax_result, remat):
    v, jemb, jloss, want = jax_result
    batch = _batch()
    port = _port_model(True, dropout=0.0)
    port.load_jax_variables(v)
    tb = ptrain._batch_to(batch, torch.device("cpu"))
    with torch.no_grad():
        pemb = [e.numpy() for e in port(*tb, return_embeddings=True)]
    pcfg = ptrain.RetrievalConfig(**CONFIG, grad_checkpointing=remat)
    opt = ptrain.make_retrieval_optimizer(pcfg, port.named_parameters(), 6)
    pstep = ptrain.build_retrieval_train_step(
        port, opt, HardNegativeMiningInfoNCE(temperature=0.07,
                                             lambda_reg=0.05), pcfg,
        torch.Generator().manual_seed(0))
    ploss = pstep(tb, torch.tensor(0.14), torch.tensor(0)).item()
    got = dict(_leaves(ptrain._variables(port, opt.mu)["params"]))

    for g, w in zip(pemb, jemb):
        np.testing.assert_allclose(g, w, rtol=0, atol=EMBED_ATOL)
    np.testing.assert_allclose(ploss, jloss, rtol=LOSS_RTOL)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("text_encoder/layers/scan/layer/") for k in got)
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.abs(w).max() <= ROUNDING * top:  # zero to rounding
            assert np.abs(g).max() <= 10 * ROUNDING * top, k
            continue
        err = np.linalg.norm(g - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w), (k, err)


@GC
def test_scanned_equals_unrolled_bit_for_bit(remat, monkeypatch):
    _scanned_against_unrolled(remat, False, monkeypatch)


@GC
def test_scanned_equals_unrolled_bit_for_bit_fused(remat, monkeypatch):
    _scanned_against_unrolled(remat, True, monkeypatch)


def _scanned_against_unrolled(remat, fused, monkeypatch):
    monkeypatch.setenv("ATQ_FUSED", "1" if fused else "0")
    calls = []
    op = fused_linear.fused_quantized_linear
    monkeypatch.setattr(fused_linear, "fused_quantized_linear",
                        lambda *a, **kw: calls.append(1) or op(*a, **kw))
    unrolled = _port_model(False, generator=torch.Generator().manual_seed(4))
    scanned = _port_model(True)
    scanned.load_state_dict(stack_layer_params(
        unrolled.state_dict(), 4, prefix="text_encoder.layers_",
        dest="text_encoder.layers"))
    rng = np.random.RandomState(2)
    batch = ptrain._batch_to(
        (rng.randint(0, 256, (BATCH, SIZE, SIZE, 3)).astype(np.uint8),)
        + _batch()[1:], torch.device("cpu"))
    out, n_calls = {}, {}
    for name, model in (("unrolled", unrolled), ("scanned", scanned)):
        calls.clear()
        cfg = ptrain.RetrievalConfig(grad_checkpointing=remat)
        gen = torch.Generator().manual_seed(9)
        step = ptrain.build_retrieval_train_step(
            model, ptrain.SgdChain(model.named_parameters(), lambda _: 0.0),
            HardNegativeMiningInfoNCE(), cfg, gen)
        loss = step(batch, torch.tensor(0.1), torch.tensor(0))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        out[name] = (loss, grads, [b.clone() for b in
                                   ptrain._batchnorm_stats(model)],
                     gen.get_state())
        n_calls[name] = len(calls)
    # Under ATQ_FUSED=1 every projection runs the fused op, the stacked
    # ones once more in their layer's recompute.
    assert n_calls == ({"unrolled": N_FUSED * (1 + remat),
                        "scanned": N_FUSED * (1 + remat) + 6 * 4} if fused
                       else {"unrolled": 0, "scanned": 0}), n_calls
    (lu, gu, su, ru), (ls, gs, ss, rs) = out["unrolled"], out["scanned"]
    assert torch.equal(lu, ls)
    gu = stack_layer_params(gu, 4, prefix="text_encoder.layers_",
                            dest="text_encoder.layers")
    assert sorted(gu) == sorted(gs)
    assert any(gs[n].abs().max() > 0 for n in gs if ".scan." in n)
    for n in gs:
        assert torch.equal(gu[n], gs[n]), n
    assert all(torch.equal(a, b) for a, b in zip(su, ss))
    assert torch.equal(ru, rs)


def test_scanned_checkpoint_embeds_the_same_on_jax(tmp_path):
    out = tmp_path / "out"
    state, _, _ = ptrain.main([
        "--device", "cpu", "--batch_size", "4", "--embed_dim", "32",
        "--hidden_dim", "64", "--image_size", "32", "--max_seq_length",
        str(SEQ), "--synthetic_images", "20", "--epochs", "1",
        "--use_residual", "--scan_layers", "--reinit_model",
        "--checkpoint_freq", "1", "--output_dir", str(out), "--data_dir",
        str(tmp_path / "none")])
    assert state["model"].text_encoder.scan_layers
    ckpt = load_checkpoint(str(out / "checkpoint_epoch_1.npz"))
    variables = ckpt["model_state_dict"]
    layer = variables["params"]["text_encoder"]["layers"]["scan"]["layer"]
    assert layer["linear1"]["weight"].shape == (4, HIDDEN, EMBED)
    assert "layers_0" not in variables["params"]["text_encoder"]
    vocab = state["model"].text_encoder.embedding.weight.shape[0]

    model = JaxRetrieval(vocab_size=vocab, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, text_scan_layers=True)
    batch = _batch(vocab)
    # The sinusoidal table of the run's final_model.npz, as a JAX init
    # makes it (the epoch checkpoint has no 'constants').
    constants = load_checkpoint(str(out / "final_model.npz"))["constants"]
    want = model.apply({**variables, "constants": constants},
                       *(jnp.asarray(a) for a in batch),
                       return_embeddings=True, train=False)
    port = ATQMultimodalRetrieval(vocab_size=vocab, embed_dim=EMBED,
                                  hidden_dim=HIDDEN, use_residual=True,
                                  max_seq_length=SEQ, text_scan_layers=True,
                                  device="cpu")
    port.load_jax_variables(variables)
    with torch.no_grad():
        got = port(*ptrain._batch_to(batch, torch.device("cpu")),
                   return_embeddings=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=EMBED_ATOL)
