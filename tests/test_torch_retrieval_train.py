"""The port's retrieval trainer (train/retrieval.py, ``python -m
atq_tpu_torch.train.retrieval``), its loaders (data/flickr8k.py) and its
full-precision baseline (models/baseline_retrieval.py) against atq_tpu's on
the CPU, at the JAX package's own small test size (vocabulary 60, embed 32,
FFN 64, images 32x32, batch 4, sequence 8; tests/test_train_steps.py).

- the loaders give the same batches per seed, uint8 and float, over two
  epochs;
- ``reinit_params`` touches the same leaves as JAX's, each within its
  bound;
- each optimizer chain (adamw, sgd, adam; with and without clipping)
  follows optax for three updates within rtol 1e-5, atol 1e-7, and the
  adamw chain decays a parity-frozen latent that the classifier's masked
  chain leaves alone;
- six train steps from one init at the recipe's rates, dropout 0 and
  float images (no random draw), with EMA and the co-trained baseline's
  distillation: the ATQ model's losses, every parameter leaf and
  BatchNorm statistic of it and its EMA (in L2 norm) and the baseline's
  parameters (as one vector) within 1e-3 relative, the retrieval
  tolerance through step 6 (benchmarks/BENCHMARKS.md:219-222); each
  leaf's step-0 gradient and change from init, in both models, against
  JAX's (the tolerances below);
- ``--grad_checkpointing`` gives the same gradients, bit for bit;
- the CLI mirrors train_multimodal.py's flags, and those of features not
  ported yet raise.

The artifact files are held against a JAX run in
tests/test_torch_retrieval_artifacts.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atq_tpu.data import flickr8k as jax_f8k
from atq_tpu.losses.contrastive import (
    ContrastiveLearningManager as JaxManager,
    HardNegativeMiningInfoNCE as JaxInfoNCE,
)
from atq_tpu.models.baseline_retrieval import (
    BaselineRetrievalModel as JaxBaseline,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.train import retrieval as jtrain
from atq_tpu_torch.data import flickr8k as pf8k
from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
from atq_tpu_torch.models.baseline_retrieval import BaselineRetrievalModel
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.nn.layers import TernaryLinear
from atq_tpu_torch.train import classifier as pclassifier
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import from_jax_variables

VOCAB, EMBED, HIDDEN, SIZE, BATCH, SEQ = 60, 32, 64, 32, 4, 8
TRAJ_RTOL = 1e-3
# The six-step trajectory's tolerances, from the port against JAX at 1,
# 2, 3, 4, 6 and 8 torch threads (the largest reading; in brackets the
# port against itself at 1 and 8 threads, then JAX's baseline in float32
# against float64): the ATQ model's step-0 gradients 1.9e-3 (1.0e-3, its
# alphas) and changes from init 3.7e-3 (3.7e-3, one alpha); the
# baseline's step-0 gradients 2.3e-4 (1.1e-4; 1.6e-4), changes 0.117
# (0.071; 0.036) and losses 1.7e-2 (6.9e-3; 1.9e-3). The baseline's 0.117
# is its image projector's first bias, element 29: its step-0 gradient is
# -2.7e-6 in JAX, +4.7e-6 in the port and -1.2e-6 in float64, against
# 0.227 for the leaf's largest, and Adam steps it a whole rate either way.
# A leaf's gradient is zero to rounding at 1e-6 of the model's largest:
# the shift- and scale-invariant leaves reach 8.9e-9, the smallest other
# 1.5e-5. ``python -m tests.test_torch_retrieval_train`` takes them.
GRAD_RTOL, ROUNDING = 5e-3, 1e-6
ATQ_CHANGE_RTOL, BASELINE_CHANGE_RTOL, BASELINE_LOSS_RTOL = 1e-2, 0.25, 5e-2
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def _vendored_tokenizer(monkeypatch):
    """The JAX side takes NLTK's punkt path when its data is installed;
    pin it to the vendored tokenizer, which the port copies."""
    monkeypatch.setattr(jax_f8k, "_USE_NLTK", False)
    monkeypatch.delenv("ATQ_SPLIT_TOKENIZER", raising=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _assert_rel(got, want, rtol, what, skip=()):
    """Each leaf but those in ``skip`` within rtol of its own L2 norm."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        if k in skip:
            continue
        err, scale = np.linalg.norm(got[k] - w), np.linalg.norm(w)
        assert err <= rtol * scale, f"{what} {k}: {err} > {rtol} * {scale}"


# ---------------------------------------------------------------- loaders


@pytest.mark.parametrize("raw_uint8", [True, False], ids=["uint8", "float"])
def test_loaders_give_the_jax_batches_per_seed(tmp_path, raw_uint8):
    kw = dict(batch_size=8, image_size=SIZE, max_length=12,
              root_dir=str(tmp_path / "absent"), synthetic_images=20,
              raw_uint8=raw_uint8, with_image_ids=True)
    want = jax_f8k.prepare_flickr8k_dataloaders(**kw)
    got = pf8k.prepare_flickr8k_dataloaders(**kw)
    assert got[3:] == want[3:]  # vocab size and word_to_idx
    for g, w in zip(got[:3], want[:3]):
        assert len(g) == len(w)
        for _ in range(2):  # two epochs: a new permutation each
            batches = list(zip(iter(g), iter(w)))
            assert batches
            for gb, wb in batches:
                assert len(gb) == len(wb)
                for a, b in zip(gb, wb):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_partial_dataset_names_the_missing_files(tmp_path):
    (tmp_path / "Flickr8k.token.txt").write_text("x.jpg#0\ta dog\n")
    with pytest.raises(FileNotFoundError, match="Flicker8k_Dataset"):
        pf8k.Flickr8kDataset(str(tmp_path))


# ---------------------------------------------------------------- reinit


def _port_model(**kw):
    kw = {"vocab_size": VOCAB, "embed_dim": EMBED, "hidden_dim": HIDDEN,
          "use_residual": True, "max_seq_length": SEQ, "device": "cpu",
          **kw}
    return ATQMultimodalRetrieval(**kw)


def _xavier_bound(keys, shape):
    """The gain-0.8 xavier bound of a JAX-layout leaf (the fans of
    atq_tpu/train/retrieval.py:reinit_params, derived here from the
    shape)."""
    fan_in, fan_out = shape[-1], int(np.prod(shape[:-1]))
    if keys[-1] == "weight" and len(shape) == 3 and "scan" in keys:
        fan_out = shape[-2]  # the stacked layer axis is no fan
    if keys[-1] == "kernel" and len(shape) > 2:  # conv HWIO
        rf = int(np.prod(shape[:-2]))
        fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    return 0.8 * np.sqrt(6.0 / (fan_in + fan_out))


@pytest.mark.parametrize("scanned", [False, True], ids=["unrolled",
                                                        "scanned"])
def test_reinit_touches_the_jax_leaves_within_their_bounds(scanned):
    """The same leaves change on both sides; a 2+-dim weight or kernel
    stays within its xavier bound on both (and reaches past 0.6 of it when
    it has 256+ entries), an embedding or 1-dim weight is N(0, 0.02)-sized
    on both, biases are zero and every other leaf is untouched."""
    params = _port_model(text_scan_layers=scanned).jax_variables()["params"]
    want = dict(_leaves(_np(jtrain.reinit_params(params,
                                                 jax.random.PRNGKey(3)))))
    got = dict(_leaves(ptrain.reinit_params(
        params, torch.Generator().manual_seed(3))))
    before = dict(_leaves(params))
    assert sorted(got) == sorted(want) == sorted(before)
    assert any("scan" in k for k in before) == scanned
    for k, b in before.items():
        g, w = got[k], want[k]
        assert g.shape == w.shape == b.shape and g.dtype == w.dtype, k
        assert np.array_equal(g, b) == np.array_equal(w, b), k
        keys = k.split("/")
        if keys[-1] == "bias":
            assert not g.any() and not w.any(), k
        elif keys[-1] in ("weight", "kernel") and g.ndim >= 2:
            bound = _xavier_bound(keys, g.shape) * (1 + 2 ** -23)  # an ulp
            for x in (g, w):
                assert np.abs(x).max() <= bound, k
                assert g.size < 256 or np.abs(x).max() > 0.6 * bound, k
        elif keys[-1] in ("weight", "kernel", "embedding"):
            for x in (g, w):
                assert np.abs(x).max() < 0.02 * 6, k
                assert x.size < 256 or 0.015 < x.std() < 0.025, k
        else:
            assert np.array_equal(g, b), k


def test_reinit_model_writes_back_through_the_jax_layout():
    model = _port_model()
    ptrain.reinit_model_(model, torch.Generator().manual_seed(0))
    q = model.text_encoder.layers_0.self_attn.q_proj.weight
    bound = 0.8 * np.sqrt(6.0 / (EMBED + EMBED))
    assert q.abs().max().item() <= bound
    assert not model.text_projector.bias.any()
    assert torch.equal(model.text_encoder.layers_0.gate,
                       torch.full((1,), 0.8))


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", ["adamw", "sgd", "adam"])
def test_optimizer_chains_match_optax(name, clip):
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32),
              "frozen": rng.randn(3, 3).astype(np.float32)}
    kw = dict(optimizer=name, clip_grad=clip, epochs=2, learning_rate=1e-2,
              weight_decay=0.1)
    tx = jtrain.make_retrieval_optimizer(jtrain.RetrievalConfig(**kw), 5)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = ptrain.make_retrieval_optimizer(ptrain.RetrievalConfig(**kw),
                                          tparams.items(), 5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for i in range(3):
        grads = {k: (rng.randn(*v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        grads["frozen"][:] = 0.0  # no gradient: a zero one, as in optax
        updates, state = tx.update({k: jnp.asarray(v)
                                    for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = None if k == "frozen" else torch.from_numpy(grads[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=f"{k} {i}")


def test_adamw_decays_what_the_classifier_chain_masks():
    """The retrieval chain's decay is unmasked: the latent weight of a
    parity TernaryLinear (no gradient) decays; under the classifier's
    masked chain it stays."""
    torch.manual_seed(0)
    moved = {}
    for which in ("retrieval", "classifier"):
        layer = TernaryLinear(8, 4, grad_mode="parity", device="cpu",
                              generator=torch.Generator().manual_seed(1))
        w0 = layer.weight.detach().clone()
        if which == "retrieval":
            opt = ptrain.make_retrieval_optimizer(ptrain.RetrievalConfig(
                epochs=1, weight_decay=0.1), layer.named_parameters(), 10)
        else:
            opt = pclassifier.AdamChain(
                layer.named_parameters(), lambda _: 5e-5, weight_decay=0.1,
                decay_mask=pclassifier.ternary_latent_decay_mask(layer,
                                                                 "parity"))
        for _ in range(2):
            layer.zero_grad(set_to_none=True)
            layer(torch.randn(3, 8)).sum().backward()
            assert layer.weight.grad is None  # parity: frozen latent
            opt.step()
        moved[which] = not torch.equal(layer.weight.detach(), w0)
    assert moved == {"retrieval": True, "classifier": False}


def test_adam_chain_betas_default_to_optax():
    opt = pclassifier.AdamChain([("p", torch.nn.Parameter(torch.zeros(2)))],
                                lambda _: 1.0)
    assert (opt.b1, opt.b2, opt.eps) == (0.9, 0.999, 1e-8)


# ---------------------------------------------------------------- trajectory


def _jax_init():
    model = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, dropout=0.0)
    sample = (jnp.zeros((2, SIZE, SIZE, 3)), jnp.zeros((2, SEQ), jnp.int32),
              jnp.asarray([4, 4], jnp.int32))
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(0), *sample))
    base = JaxBaseline(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN)
    bv = _np(jax.jit(base.init)(jax.random.PRNGKey(5), *sample))
    return model, v, base, bv


def _batches(n):
    rng = np.random.RandomState(11)
    return [(rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
             rng.randint(4, VOCAB, (BATCH, SEQ)).astype(np.int32),
             rng.randint(2, SEQ + 1, BATCH).astype(np.int32))
            for _ in range(n)]


def _flat(tree):
    return np.concatenate([v.ravel() for _, v in sorted(_leaves(tree))])


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for part in opt_state if isinstance(opt_state, tuple) else ():
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def _rounding_level(nu):
    """Leaves whose gradient is zero to rounding over the run but not
    exactly zero: the RMS of their gradients (√ of Adam's largest second
    moment) is above 0 and at most ``ROUNDING`` of the model's largest.
    Adam turns such noise into steps of about ±rate, so these leaves move
    either way in either package (and in the port against itself at 1 and
    8 threads)."""
    rms = {k: float(np.sqrt(x.max())) for k, x in _leaves(nu)}
    top = max(rms.values())
    return {k for k, r in rms.items() if 0 < r <= ROUNDING * top}


# The trajectory: the recipe's rate and schedule shape (5e-5, warmup over
# the first 10 % of a 10-epoch run of 6 steps an epoch), steps 0-2 at the
# easy-positive curriculum and 3-5 at the hard one.
TRAJ_CONFIG = dict(batch_size=BATCH, image_size=SIZE, embed_dim=EMBED,
                   hidden_dim=HIDDEN, use_residual=True, max_seq_length=SEQ,
                   use_ema=True, train_baseline=True, distill=True,
                   epochs=10, learning_rate=5e-5, contrastive_reg=0.05)
TRAJ_STEPS_PER_EPOCH, TRAJ_TEMPERATURE = 6, 0.14
TRAJ_KINDS = (0, 0, 0, 2, 2, 2)


def _jax_trajectory(model, v, base, bv):
    """Six JAX steps: each updates the baseline, then the ATQ model
    distilled from the baseline's updated embeddings, then the EMA."""
    cfg = jtrain.RetrievalConfig(**TRAJ_CONFIG)
    tx = jtrain.make_retrieval_optimizer(cfg, TRAJ_STEPS_PER_EPOCH)
    crit = JaxInfoNCE(temperature=0.07, lambda_reg=0.05)
    step = jax.jit(jtrain.build_retrieval_train_step(
        model, tx, crit, JaxManager(criterion=crit), cfg))
    btx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
    bstep = jax.jit(jtrain.build_baseline_train_step(base, btx, crit))
    state = {"params": v["params"], "quant": v["quant"],
             "constants": v["constants"], "batch_stats": v["batch_stats"],
             "opt_state": tx.init(v["params"]),
             "step": jnp.asarray(0, jnp.int32), "ema_params": v["params"]}
    bstate = {"params": bv["params"], "batch_stats": bv["batch_stats"],
              "opt_state": btx.init(bv["params"])}
    out = {"losses": [], "blosses": []}
    for i, (batch, kind) in enumerate(zip(_batches(6), TRAJ_KINDS)):
        jb = tuple(jnp.asarray(a) for a in batch)
        bstate, bloss, embeds = bstep(bstate, jb,
                                      jnp.float32(TRAJ_TEMPERATURE),
                                      jax.random.PRNGKey(2))
        state, loss = step(state, jb, jnp.float32(TRAJ_TEMPERATURE),
                           jnp.int32(kind), jax.random.PRNGKey(1), embeds)
        out["losses"].append(float(loss))
        out["blosses"].append(float(bloss))
        if i == 0:
            out["mu0"] = _np(_adam_state(state["opt_state"]).mu)
            out["bmu0"] = _np(_adam_state(bstate["opt_state"]).mu)
    adam, badam = (_adam_state(state["opt_state"]),
                   _adam_state(bstate["opt_state"]))
    return {**out, "params": _np(state["params"]),
            "ema": _np(state["ema_params"]),
            "batch_stats": _np(state["batch_stats"]), "nu": _np(adam.nu),
            "bparams": _np(bstate["params"]), "bnu": _np(badam.nu)}


def _port_trajectory(v, bv):
    """The same six steps in the port, from the same variables."""
    cfg = ptrain.RetrievalConfig(**TRAJ_CONFIG)
    port = _port_model(dropout=0.0)
    port.load_jax_variables(v)
    pbase = BaselineRetrievalModel(VOCAB, EMBED, HIDDEN, device="cpu")
    pbase.load_state_dict(from_jax_variables(bv))
    opt = ptrain.make_retrieval_optimizer(cfg, port.named_parameters(),
                                          TRAJ_STEPS_PER_EPOCH)
    ema = [p.detach().clone() for p in port.parameters()]
    crit = HardNegativeMiningInfoNCE(temperature=0.07, lambda_reg=0.05)
    gen = torch.Generator().manual_seed(0)
    step = ptrain.build_retrieval_train_step(port, opt, crit, cfg, gen, ema)
    bopt = pclassifier.AdamChain(pbase.named_parameters(),
                                 lambda _: cfg.learning_rate,
                                 decoupled_weight_decay=cfg.weight_decay)
    bstep = ptrain.build_baseline_train_step(pbase, bopt, crit, gen)

    def tree(model, tensors=None):
        return ptrain._variables(
            model, None if tensors is None else
            [t.clone() for t in tensors])["params"]

    out = {"losses": [], "blosses": []}
    t = torch.tensor(TRAJ_TEMPERATURE)
    for i, (batch, kind) in enumerate(zip(_batches(6), TRAJ_KINDS)):
        tb = ptrain._batch_to(batch, torch.device("cpu"))
        bloss, embeds = bstep(tb, t)
        out["losses"].append(step(tb, t, torch.tensor(kind), embeds).item())
        out["blosses"].append(bloss.item())
        if i == 0:
            out["mu0"], out["bmu0"] = tree(port, opt.mu), tree(pbase, bopt.mu)
    return {**out, "params": tree(port), "ema": tree(port, ema),
            "batch_stats": port.jax_variables()["batch_stats"],
            "nu": tree(port, opt.nu), "bparams": tree(pbase),
            "bnu": tree(pbase, bopt.nu)}


def _leaf_errors(p0, got, want, prefix=""):
    """Leaf by leaf, in L2 norm relative to the reference's: the step-0
    gradient (Adam's first moment after one step, 0.1 of it) and the
    change from init, leaving out the leaves zero to rounding in ``want``
    (returned as the third value)."""
    mu_g, mu_w = (dict(_leaves(x[prefix + "mu0"])) for x in (got, want))
    p_g, p_w = (dict(_leaves(x[prefix + "params"])) for x in (got, want))
    noise = _rounding_level(want[prefix + "nu"])
    grad, change = {}, {}
    for k, p in _leaves(p0):
        if k in noise:
            continue
        grad[k] = (np.linalg.norm(mu_g[k] - mu_w[k]),
                   np.linalg.norm(mu_w[k]))
        change[k] = (np.linalg.norm(p_g[k] - p_w[k]),
                     np.linalg.norm(p_w[k] - p))
    return grad, change, noise


def _assert_moves_like_jax(what, p0, got, want, prefix, change_rtol):
    """The step-0 gradient of every leaf within ``GRAD_RTOL`` and its
    change from init within ``change_rtol`` of JAX's (equal where JAX's
    is zero: a leaf with no gradient only decays, by nothing while the
    rate rounds the decay away). A leaf whose JAX gradient is zero to
    rounding must be so in the port too, and is not held."""
    grad, change, noise = _leaf_errors(p0, got, want, prefix)
    assert noise == _rounding_level(got[prefix + "nu"]), what
    for k, (err, scale) in grad.items():
        assert err <= GRAD_RTOL * scale, f"{what} gradient {k}: {err} {scale}"
    for k, (err, scale) in change.items():
        assert err <= change_rtol * scale, f"{what} change {k}: {err} {scale}"
    return noise


def test_six_steps_follow_the_jax_trajectory():
    """Six train steps of the ATQ model at the recipe's rate and schedule
    shape (``TRAJ_CONFIG``), with the co-trained baseline at the recipe's
    constant 5e-5, from JAX's variables.

    Tolerances. The ATQ model: losses, and every parameter leaf, EMA leaf
    and BatchNorm statistic in L2 norm, within 1e-3 relative (the
    retrieval tolerance through step 6, benchmarks/BENCHMARKS.md:219-222).
    Both models, leaf by leaf: the step-0 gradient within ``GRAD_RTOL``
    and the change from init within ``ATQ_CHANGE_RTOL`` or
    ``BASELINE_CHANGE_RTOL`` of JAX's (``_assert_moves_like_jax``). The
    baseline: its parameters as one vector within 1e-3 and its losses
    within ``BASELINE_LOSS_RTOL``. The last two tolerances are wide
    because the baseline's float32 trajectory is not reproducible at this
    size in either package: ResNet-18 at 32x32 and batch 4 ends in
    BatchNorm over 4 values a channel, and Adam scales each element's step
    by its own gradient, so small differences in small gradients move
    whole steps (the readings above ``GRAD_RTOL``; ``python -m
    tests.test_torch_retrieval_train`` takes them)."""
    model, v, base, bv = _jax_init()
    want = _jax_trajectory(model, v, base, bv)
    got = _port_trajectory(v, bv)

    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TRAJ_RTOL)
    np.testing.assert_allclose(got["blosses"], want["blosses"],
                               rtol=BASELINE_LOSS_RTOL)
    assert len(set(got["losses"])) == 6
    noise = _assert_moves_like_jax("atq", v["params"], got, want, "",
                                   ATQ_CHANGE_RTOL)
    # Shift- and scale-invariant leaves: a bias added to every key or to
    # every pooling score, and a scale that the L2 normalisation removes.
    assert noise == {"image_encoder/scaling",
                     "text_encoder/attention_pool_2/bias",
                     *(f"text_encoder/layers_{i}/self_attn/k_proj/bias"
                       for i in range(4))}
    for what, skip in (("params", noise), ("ema", noise),
                       ("batch_stats", ())):
        _assert_rel(got[what], want[what], TRAJ_RTOL, what, skip)
    g, w = _flat(got["bparams"]), _flat(want["bparams"])
    assert np.linalg.norm(g - w) <= TRAJ_RTOL * np.linalg.norm(w)
    assert not _assert_moves_like_jax("baseline", bv["params"], got, want,
                                      "b", BASELINE_CHANGE_RTOL)


def test_grad_checkpointing_gives_the_same_gradients():
    """Dropout 0.1 active, uint8 images (the flip on): the checkpointed
    step replays the generator in its recompute, so gradients, BatchNorm
    statistics and the generator's state end as without it."""
    batch = ptrain._batch_to(
        (np.random.RandomState(2).randint(0, 256, (BATCH, SIZE, SIZE, 3))
         .astype(np.uint8),) + _batches(1)[0][1:], torch.device("cpu"))
    out = {}
    for remat in (False, True):
        model = _port_model(generator=torch.Generator().manual_seed(4))
        cfg = ptrain.RetrievalConfig(grad_checkpointing=remat)
        gen = torch.Generator().manual_seed(9)
        step = ptrain.build_retrieval_train_step(
            model, pclassifier.SgdChain(model.named_parameters(),
                                           lambda _: 0.0),
            HardNegativeMiningInfoNCE(), cfg, gen)
        loss = step(batch, torch.tensor(0.1), torch.tensor(0))
        out[remat] = (loss, {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None},
                      [b.clone() for b in ptrain._batchnorm_stats(model)],
                      gen.get_state())
    (l0, g0, s0, r0), (l1, g1, s1, r1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1) and len(g0) > 50
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert torch.equal(r0, r1)


def test_dropout_draws_from_the_callers_generator():
    """Training-mode dropout (text encoder, transformer layers, attention,
    fusion) takes its masks from the generator passed in, not from torch's
    global one: the same seed gives the same embeddings, another seed
    other ones, and the global RNG is left alone. Without dropout the
    forward keeps its bits."""
    model = _port_model(generator=torch.Generator().manual_seed(1))
    args = ptrain._batch_to(_batches(1)[0], torch.device("cpu"))
    state = torch.get_rng_state()

    def fused(seed, train=True):
        with torch.no_grad():
            return model(*args, return_fused=True, train=train,
                         generator=torch.Generator().manual_seed(seed))

    first, again, other = fused(5), fused(5), fused(6)
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert torch.equal(fused(5, train=False), fused(6, train=False))


def test_fused_attention_with_dropout_takes_the_einsum_branch():
    from atq_tpu_torch.nn import attention as tatt

    tatt._warned_fused_dropout = False
    model = _port_model(text_attn_impl="fused")
    step = ptrain.build_retrieval_train_step(
        model, pclassifier.SgdChain(model.named_parameters(),
                                       lambda _: 0.0),
        HardNegativeMiningInfoNCE(), ptrain.RetrievalConfig(),
        torch.Generator().manual_seed(0))
    with pytest.warns(UserWarning, match="einsum"):
        loss = step(ptrain._batch_to(_batches(1)[0], torch.device("cpu")),
                    torch.tensor(0.1), torch.tensor(1))
    assert torch.isfinite(loss)


# ---------------------------------------------------------------- the CLI


UNPORTED = [["--dp", "2"], ["--tp", "2"], ["--fsdp"]]


@pytest.mark.parametrize("flags", UNPORTED, ids=[f[0] for f in UNPORTED])
def test_unported_flags_raise(tmp_path, flags):
    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        ptrain.main(["--device", "cpu", "--output_dir", str(out)] + flags)
    assert not out.exists()


def test_parser_mirrors_train_multimodal():
    import train_multimodal

    def flags(parser):
        return {a.dest: (a.default, a.type, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    want, got = flags(train_multimodal.build_parser()), flags(
        ptrain.build_parser())
    assert sorted(got) == sorted(want)
    for dest in want:
        if dest != "device":
            assert got[dest] == want[dest], dest
    assert got["device"] == ("cuda", str, ("cpu", "cuda"))


def _readings(got, want, v, bv):
    """The largest relative differences that the trajectory test holds."""
    out = {}
    for name, prefix, p0 in (("atq", "", v["params"]),
                             ("baseline", "b", bv["params"])):
        if prefix + "mu0" not in got:
            continue
        losses = np.asarray(got[prefix + "losses"])
        ref = np.asarray(want[prefix + "losses"])
        grad, change, _ = _leaf_errors(p0, got, want, prefix)
        # Changes that float32 holds: above its spacing at the leaf's size
        # (a float64 reference decays the temperature by less).
        size = {k: np.linalg.norm(x) for k, x in _leaves(p0)}
        out[name] = {
            "losses": float(np.max(np.abs(losses - ref) / np.abs(ref))),
            "gradient": float(max(e / s for e, s in grad.values() if s > 0)),
            "change": float(max(
                e / s for k, (e, s) in change.items()
                if s > np.finfo(np.float32).eps * size[k]))}
    return out


def _jax_baseline_float64(base, bv):
    """The JAX baseline's six steps in float64 (its BatchNorm computes in
    float32 whatever the input; flax's GRU carry is made float64 here)."""
    import flax.linen as fnn

    def carry(self, rng, input_shape):
        return self.carry_init(rng, input_shape[:-1] + (self.features,),
                               jnp.float64)

    fnn.GRUCell.initialize_carry = fnn.module.nowrap(carry)
    with jax.enable_x64(True):
        to64 = jax.tree_util.Partial(jax.tree_util.tree_map,
                                     lambda a: jnp.asarray(a, jnp.float64))
        cfg = jtrain.RetrievalConfig(**TRAJ_CONFIG)
        btx = optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay)
        bstep = jax.jit(jtrain.build_baseline_train_step(
            base, btx, JaxInfoNCE(temperature=0.07, lambda_reg=0.05)))
        bstate = {"params": to64(bv["params"]),
                  "batch_stats": to64(bv["batch_stats"])}
        bstate["opt_state"] = btx.init(bstate["params"])
        out = {"blosses": []}
        for i, batch in enumerate(_batches(6)):
            jb = (jnp.asarray(batch[0], jnp.float64),) + tuple(
                jnp.asarray(a) for a in batch[1:])
            bstate, bloss, _ = bstep(bstate, jb,
                                     jnp.float64(TRAJ_TEMPERATURE),
                                     jax.random.PRNGKey(2))
            out["blosses"].append(float(bloss))
            if i == 0:
                out["bmu0"] = _np(_adam_state(bstate["opt_state"]).mu)
        out["bparams"] = _np(bstate["params"])
        out["bnu"] = _np(_adam_state(bstate["opt_state"]).nu)
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_retrieval_train: the readings behind the
    # trajectory's tolerances (a few minutes on 8 cores): the port against
    # JAX at 1 to 8 torch threads, the port against itself at 1 and 8
    # threads, JAX's baseline in float32 against float64, and the gap
    # between the leaves zero to rounding and the rest.
    import json

    jax.config.update("jax_platforms", "cpu")
    model, v, base, bv = _jax_init()
    want = _jax_trajectory(model, v, base, bv)
    runs = {}
    for n in (1, 2, 3, 4, 6, 8):
        torch.set_num_threads(n)
        runs[n] = _port_trajectory(v, bv)
        print(json.dumps({"port_vs_jax": n,
                          **_readings(runs[n], want, v, bv)}))
    print(json.dumps({"port_1_vs_8_threads": _readings(runs[1], runs[8],
                                                       v, bv)}))
    f64 = _jax_baseline_float64(base, bv)
    print(json.dumps({"jax_float32_vs_float64": _readings(
        {k: want[k] for k in f64}, f64, v, bv)}))
    # The baseline's worst change at 8 threads: its leaf and element, with
    # that element's step-0 gradient in JAX, the port and float64.
    _, change, _ = _leaf_errors(bv["params"], runs[8], want, "b")
    leaf = max(change, key=lambda k: change[k][0] / change[k][1])
    got8, ref, ref64 = (dict(_leaves(x))[leaf] for x in (
        runs[8]["bparams"], want["bparams"], f64["bparams"]))
    i = int(np.argmax(np.abs(got8 - ref)))
    print(json.dumps({"baseline_worst_change": leaf, "element": i, **{
        name: float(dict(_leaves(x["bmu0"]))[leaf].ravel()[i] / 0.1)
        for name, x in (("jax_gradient", want), ("port_gradient", runs[8]),
                        ("float64_gradient", f64))},
        "leaf_largest_gradient": float(np.abs(dict(_leaves(
            want["bmu0"]))[leaf]).max() / 0.1)}))
    rms = {k: float(np.sqrt(x.max())) for k, x in _leaves(want["nu"])}
    top, noise = max(rms.values()), _rounding_level(want["nu"])
    print(json.dumps({"rounding_leaves": sorted(noise),
                      "largest_rounding": max(rms[k] for k in noise) / top,
                      "smallest_other": min(r for k, r in rms.items()
                                            if r > 0 and k not in noise)
                      / top}))
