"""``--use_amp`` in the port's retrieval model and trainer against the JAX
package's ``compute_dtype=bfloat16`` on the CPU, at the JAX package's small
test widths (vocabulary 60, embed 32, FFN 64, images 32x32, batch 8,
sequence 8; the model's text tower has 4 layers in both packages), from
JAX's init with each ternary layer at its optimal alpha.

bf16 roundings do not compare element by element across two
implementations: a convolution that sums in another order flips an
output's last bf16 bit now and then (a single stem convolution: 0.014 % of
its outputs, by one bf16 ulp), and the flips carry through the ResNet. So
the port is held to its distance from JAX's AMP run *relative to* AMP's own
distance from JAX's float32 run: ``mean|port - jax_bf16| / mean|jax_bf16 -
jax_f32|``. A port that computes where JAX does in bf16 reads well below 1,
one that computes elsewhere (a BatchNorm in bf16, a convolution in float32)
reads about 1. The readings (``python -m tests.test_torch_retrieval_amp``,
one torch thread as the tests run; the same at eight but where noted)
and their limits:

JAX runs jitted with ``xla_allow_excess_precision=False``: by default XLA
keeps a bf16 convolution's output in float32 where a float32 op follows,
which flax's module semantics (and JAX run op by op) do not.

- the forward in eval mode: image embeddings 0.104 (limit 0.3), text
  embeddings 0.020 (0.06), the fused embedding 0.17 (0.45); a BatchNorm
  computed in bf16 reads 1.19 and 1.30 and must fail;
- the gradients of ``<embeddings, fixed cotangents>`` in eval mode: ResNet
  leaves 0.057 (limit 0.25), the image encoder's other leaves 0.24 (0.6),
  the text side 0.12 (0.3), one-element leaves 0.30 (0.6); a BatchNorm in
  bf16 reads 0.72 on the ResNet leaves (1.17 and 1.23 on the image
  encoder's and one-element ones) and must fail;
- the trainer's step 0 (train mode, dropout 0, float images): in train
  mode BatchNorm over 8 images turns those flips into percent-level
  differences that no comparison of two implementations can separate from
  a fault (JAX jitted against JAX op by op: 57 % of a ResNet leaf's and
  2.8x an alpha's gradient, in L2), so it is held coarsely: the loss within
  3e-2 (reading 8.0e-3; 1.2e-2 at eight threads) and, leaf group by group,
  the ratio above within 1.5 (readings 0.40-0.84; 0.31-0.58 at eight
  threads); and the
  AMP step's ternary patterns and thresholds equal the float32 step's bit
  for bit (the quantizer stays float32), every threshold computed on a
  float32 weight.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from unittest import mock

from atq_tpu.losses.contrastive import (
    ContrastiveLearningManager as JaxManager,
    HardNegativeMiningInfoNCE as JaxInfoNCE,
)
from atq_tpu.models.retrieval import ATQMultimodalRetrieval as JaxRetrieval
from atq_tpu.train import retrieval as jtrain
from atq_tpu_torch.core import quantize as pquantize
from atq_tpu_torch.losses.contrastive import HardNegativeMiningInfoNCE
from atq_tpu_torch.models import resnet as presnet
from atq_tpu_torch.models.retrieval import ATQMultimodalRetrieval
from atq_tpu_torch.nn import layers as players
from atq_tpu_torch.train import retrieval as ptrain
from atq_tpu_torch.utils.jax_interop import to_jax_variables

VOCAB, EMBED, HIDDEN, SIZE, BATCH, SEQ = 60, 32, 64, 32, 8, 8
FORWARD_LIMIT = {"image": 0.3, "text": 0.06, "fused": 0.45}
GRAD_LIMIT = {"trunk": 0.25, "image": 0.6, "text": 0.3, "scalar": 0.6}
STEP_LOSS_RTOL, STEP_GRAD_LIMIT = 3e-2, 1.5
LITERAL = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, and more threads each only contend (the readings
    above were taken at one thread)."""
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


def _optimal_alphas(params, quant):
    """Each ternary layer's alpha at its optimal value (the quantizer's,
    bit-exact in both packages), so the text tower is not saturated as at
    alpha 1."""
    for k, node in params.items():
        if not isinstance(node, dict):
            continue
        q = quant.get(k, {}) if isinstance(quant, dict) else {}
        if "alpha" in node and "weight" in node:
            _, a = pquantize.adaptive_ternary_quantization(
                torch.from_numpy(np.array(node["weight"])),
                sparsity_target=float(q.get("sparsity_target", 0.3)))
            node["alpha"] = np.full((1,), float(a), np.float32)
        else:
            _optimal_alphas(node, q)


def _setup():
    model = JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED,
                         hidden_dim=HIDDEN, use_residual=True,
                         max_seq_length=SEQ, dropout=0.0)
    sample = (jnp.zeros((2, SIZE, SIZE, 3)), jnp.zeros((2, SEQ), jnp.int32),
              jnp.asarray([4, 4], jnp.int32))
    v = _np(jax.jit(model.init)(jax.random.PRNGKey(0), *sample))
    _optimal_alphas(v["params"], v["quant"])
    rng = np.random.RandomState(1)
    batch = (rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
             rng.randint(4, VOCAB, (BATCH, SEQ)).astype(np.int32),
             rng.randint(2, SEQ + 1, BATCH).astype(np.int32))
    return v, batch


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _jax_model(amp):
    return JaxRetrieval(vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
                        use_residual=True, max_seq_length=SEQ, dropout=0.0,
                        compute_dtype=jnp.bfloat16 if amp else None)


def _port_model(v, amp=True):
    model = ATQMultimodalRetrieval(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN,
        use_residual=True, max_seq_length=SEQ, dropout=0.0, device="cpu",
        compute_dtype=torch.bfloat16 if amp else None)
    model.load_jax_variables(v)
    return model


def _bn_in_bf16(self, x):
    return presnet._BatchNorm.forward(self, x.to(torch.bfloat16)).float()


def _fault(name):
    """A planted AMP fault: BatchNorm computed in bf16."""
    if name is None:
        return contextlib.nullcontext()
    return mock.patch.object(presnet._BatchNorm32, "forward", _bn_in_bf16)


def _group(name, size):
    if name.startswith("image_encoder/base_model/"):
        return "trunk"
    if size == 1:
        return "scalar"
    return "image" if name.startswith("image_encoder/") else "text"


def _ratios(got, amp, f32, group):
    """Per group: sum|got - amp| / sum|amp - f32| over the group's
    elements (``group(name, size)`` names it)."""
    sums = {}
    for k, a in amp.items():
        s = sums.setdefault(group(k, a.size), [0.0, 0.0])
        s[0] += float(np.abs(got[k] - a).sum())
        s[1] += float(np.abs(a - f32[k]).sum())
    return {g: d / n for g, (d, n) in sums.items()}


def _outputs(out, mode):
    names = ("image", "text") if mode == "embeddings" else ("fused",)
    return dict(zip(names, (np.asarray(o) for o in (
        out if mode == "embeddings" else (out,)))))


def _kwargs(mode):
    return ({"return_embeddings": True} if mode == "embeddings"
            else {"return_fused": True})


def _forward_ratios(setup, mode, faults=(None,)):
    """The eval-mode forward's ratios, one dict for each of ``faults``."""
    v, batch = setup
    kw = _kwargs(mode)
    amp, f32 = (_outputs(jax.jit(lambda v, b, a=a: _jax_model(a).apply(
        v, *b, train=False, **kw), compiler_options=LITERAL)(v, batch), mode)
        for a in (True, False))
    out = []
    for fault in faults:
        with _fault(fault), torch.no_grad():
            got = _port_model(v)(*ptrain._batch_to(batch,
                                                   torch.device("cpu")),
                                 train=False, **kw)
        out.append(_ratios(_outputs(got, mode), amp, f32, lambda k, _: k))
    return out


@pytest.mark.parametrize("mode", ["embeddings", "fused"])
def test_amp_forward_matches_jax(setup, mode):
    ratios, faulty = _forward_ratios(setup, mode, (None, "bn_bf16"))
    for k, r in ratios.items():
        assert r <= FORWARD_LIMIT[k], (k, ratios)
    assert any(r > FORWARD_LIMIT[k] for k, r in faulty.items()), faulty


def _cotangents():
    rng = np.random.RandomState(7)
    return (rng.randn(BATCH, EMBED).astype(np.float32),
            rng.randn(BATCH, EMBED).astype(np.float32))


def _jax_eval_grads(v, batch, amp):
    model, (ci, ct) = _jax_model(amp), _cotangents()

    def f(params):
        img, txt = model.apply({**v, "params": params}, *batch,
                               return_embeddings=True, train=False)
        return jnp.vdot(img, ci) + jnp.vdot(txt, ct)

    return dict(_leaves(_np(jax.jit(jax.grad(f), compiler_options=LITERAL)(
        v["params"]))))


def _port_grads(model):
    sd = {**model.state_dict(),
          **{k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}}
    return dict(_leaves(to_jax_variables(sd)["params"]))


def _port_eval_grads(v, batch, fault=None):
    model, (ci, ct) = _port_model(v), _cotangents()
    with _fault(fault):
        img, txt = model(*ptrain._batch_to(batch, torch.device("cpu")),
                         return_embeddings=True, train=False)
        ((img * torch.from_numpy(ci)).sum()
         + (txt * torch.from_numpy(ct)).sum()).backward()
    return _port_grads(model)


def test_amp_gradients_match_jax(setup):
    v, batch = setup
    amp, f32 = (_jax_eval_grads(v, batch, a) for a in (True, False))
    ratios = _ratios(_port_eval_grads(v, batch), amp, f32, _group)
    for g, r in ratios.items():
        assert r <= GRAD_LIMIT[g], (g, ratios)
    faulty = _ratios(_port_eval_grads(v, batch, "bn_bf16"), amp, f32,
                     _group)
    assert faulty["trunk"] > GRAD_LIMIT["trunk"], faulty


def _capture():
    """An optax transformation that keeps the gradients in its state."""
    def update(u, s, p=None):
        return jax.tree_util.tree_map(jnp.zeros_like, u), {"g": u}

    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


CFG = dict(use_residual=True, embed_dim=EMBED, hidden_dim=HIDDEN,
           contrastive_reg=0.05)


def _jax_step0(v, batch, amp):
    crit = JaxInfoNCE(temperature=0.07, lambda_reg=0.05)
    step = jtrain.build_retrieval_train_step(
        _jax_model(amp), _capture(), crit, JaxManager(criterion=crit),
        jtrain.RetrievalConfig(**CFG))
    state = {"params": v["params"], "quant": v["quant"],
             "constants": v["constants"], "batch_stats": v["batch_stats"],
             "opt_state": _capture().init(v["params"]),
             "step": jnp.asarray(0, jnp.int32)}
    new, loss = jax.jit(step, compiler_options=LITERAL)(
        state, tuple(map(jnp.asarray, batch)), jnp.float32(0.07),
        jnp.int32(0), jax.random.PRNGKey(1))
    return float(loss), dict(_leaves(_np(new["opt_state"]["g"])))


class _NoUpdate:
    def step(self):
        pass


@contextlib.contextmanager
def recorded_quantizer():
    """Records every threshold (with its weight's dtype) and every ternary
    pattern the quantized layers compute."""
    calls = {"thresholds": [], "patterns": []}
    threshold, quantize = pquantize.ternary_threshold, players._quantize

    def rec_threshold(weights, *a, **k):
        t = threshold(weights, *a, **k)
        calls["thresholds"].append((weights.dtype, t.detach().clone()))
        return t

    def rec_quantize(*a, **k):
        w_t, alpha = quantize(*a, **k)
        calls["patterns"].append(w_t.detach().clone())
        return w_t, alpha

    with mock.patch.object(pquantize, "ternary_threshold", rec_threshold), \
            mock.patch.object(players, "_quantize", rec_quantize):
        yield calls


def _port_step0(v, batch, amp):
    model = _port_model(v, amp)
    step = ptrain.build_retrieval_train_step(
        model, _NoUpdate(), HardNegativeMiningInfoNCE(temperature=0.07,
                                                      lambda_reg=0.05),
        ptrain.RetrievalConfig(**CFG))
    with recorded_quantizer() as calls:
        loss = step(ptrain._batch_to(batch, torch.device("cpu")),
                    torch.tensor(0.07), torch.tensor(0))
    return float(loss), _port_grads(model), calls


def test_amp_step0_matches_jax(setup):
    v, batch = setup
    want_loss, want = _jax_step0(v, batch, True)
    _, want_f32 = _jax_step0(v, batch, False)
    loss, got, calls = _port_step0(v, batch, True)
    assert abs(loss - want_loss) <= STEP_LOSS_RTOL * abs(want_loss)
    assert all(np.isfinite(g).all() for g in got.values())
    ratios = _ratios(got, want, want_f32, _group)
    for g, r in ratios.items():
        assert r <= STEP_GRAD_LIMIT, (g, ratios)
    _, _, calls32 = _port_step0(v, batch, False)
    for key in ("thresholds", "patterns"):
        assert len(calls[key]) == len(calls32[key]) > 20
    for (dtype, t), (_, t32) in zip(calls["thresholds"],
                                    calls32["thresholds"]):
        assert dtype == torch.float32 and torch.equal(t, t32)
    for p, p32 in zip(calls["patterns"], calls32["patterns"]):
        assert p.dtype == torch.float32 and torch.equal(p, p32)


if __name__ == "__main__":
    # python -m tests.test_torch_retrieval_amp: the readings behind the
    # limits above, at one torch thread as the tests run.
    import json

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    s = _setup()
    for mode in ("embeddings", "fused"):
        faults = (None, "bn_bf16")
        for fault, r in zip(faults, _forward_ratios(s, mode, faults)):
            print(json.dumps({"forward": mode, "fault": fault, **r}))
    v, batch = s
    amp, f32 = (_jax_eval_grads(v, batch, a) for a in (True, False))
    for fault in (None, "bn_bf16"):
        print(json.dumps({"eval_gradients": fault, **_ratios(
            _port_eval_grads(v, batch, fault), amp, f32, _group)}))
    want_loss, want = _jax_step0(v, batch, True)
    _, want_f32 = _jax_step0(v, batch, False)
    loss, got, _ = _port_step0(v, batch, True)
    print(json.dumps({"step0_loss_rel": abs(loss - want_loss) / want_loss,
                      **_ratios(got, want, want_f32, _group)}))
