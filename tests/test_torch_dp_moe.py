"""``--moe_experts`` under ``--dp 2`` (train/retrieval.py, parallel/moe.py
``_route``) in a gloo world of 2 on the CPU, against JAX's jitted step on a
dp=2 mesh and the port's one-process step on the same global batch
(tests/_dp_reference.py's size and limits; 2 experts, capacity
ceil(64 / 2 · 1.25) = 40 over the global batch's 64 tokens).

Each layer's ``norm2`` bias is set along a unit vector u and the gate to
(2u, −2u), so the tokens all route to expert 0: it overflows (40 of the 64
kept). JAX routes over the global token set, so a token's slot counts the
tokens of the ranks before it and the capacity is the global batch's; the
port's ranks do the same (an exclusive scan of the per-expert counts over
the data group, the statistics all-reduced), and their step matches. A
planted fault, each rank routing its 32 tokens alone (its own capacity of
20 and its own slots, as a per-device step would), must fail the same
comparison.
"""

import numpy as np
import pytest

import _dp_reference as ref
import _torch_dist as td

EXPERTS = 2


def _overflowing(v):
    """``v`` with every MoE layer routing all its tokens to expert 0."""
    u = np.zeros(ref.EMBED, np.float32)
    u[3] = 1.0
    enc = v["params"]["text_encoder"]
    for name, layer in enc.items():
        if "moe_gate" in layer:
            layer["norm2"]["bias"] = 3.0 * u
            layer["moe_gate"] = np.stack([2.0 * u, -2.0 * u], axis=1)
    return v


@pytest.fixture(scope="module")
def runs():
    model, v = ref.jax_init(text_moe_experts=EXPERTS)
    v = _overflowing(v)
    b = ref.batch(full_length=True)
    cfg = {"moe_experts": EXPERTS}
    moe = {"text_moe_experts": EXPERTS}
    want = ref.jax_mesh_step(model, v, b, {**ref.CFG, **cfg})
    one = td.launch(1, td.retrieval_steps, [
        ref.spec(v, b, model=moe, cfg=cfg),
        ref.spec(v, ref.perturbed(b), model=moe, cfg=cfg)])[0]
    ranks = td.launch(2, td.retrieval_steps, [
        ref.spec(v, b, model=moe, cfg=cfg, dp=2),
        ref.spec(v, b, model=moe, cfg=cfg, dp=2, planted=True)])[0]
    return {"jax": want, "port1": one[0], "envelope": one,
            "dp2": ranks[0], "planted": ranks[1]}


def test_moe_dp2_matches_jax_mesh_and_one_process(runs):
    for want, what in ((runs["jax"], "jax dp2"), (runs["port1"], "port")):
        ref.assert_step_like(runs["dp2"], want, f"moe dp2 vs {what}",
                             runs["envelope"])


def test_per_rank_routing_is_caught(runs):
    """The planted per-rank capacity moves the loss and the experts'
    gradients past the limits."""
    for want in (runs["jax"], runs["port1"]):
        with pytest.raises(AssertionError):
            ref.assert_step_like(runs["planted"], want, "planted",
                                 runs["envelope"])
    errors = ref.grad_errors(runs["planted"]["grads"], runs["jax"]["grads"],
                             runs["envelope"])
    assert max(v for k, v in errors.items() if "moe_w" in k) > 1.0
