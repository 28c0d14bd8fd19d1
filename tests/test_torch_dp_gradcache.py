"""GradCache (``--grad_accum_steps 2``) under ``--dp 2``
(train/retrieval.py ``_gradcache_step``) in a gloo world of 2 on the CPU,
against JAX's jitted GradCache step on a dp=2 mesh and the port's
one-process GradCache step on the same global batch (tests/_dp_reference.py's
size and limits).

JAX splits the global batch into the microbatches and then shards each, so
rank r embeds the r-th half of each global microbatch, BatchNorm's
statistics are each global microbatch's, pass 1 all-gathers each
microbatch's embeddings into the negative pool and pass 2 backpropagates
the rank's rows of the pool's gradient. With dropout 0.1 and uint8 images
the dp=2 step keeps the one-process step's draws (each microbatch's flips
and masks, in order) and ends with its generator state.
"""

import numpy as np
import pytest

import _dp_reference as ref
import _torch_dist as td

CFG = {"grad_accum_steps": 2}


@pytest.fixture(scope="module")
def runs():
    model, v = ref.jax_init()
    b = ref.batch()
    want = ref.jax_mesh_step(model, v, b, {**ref.CFG, **CFG})
    bd = ref.batch(uint8=True)
    drop = dict(model={"dropout": 0.1}, seed=5)
    one = td.launch(1, td.retrieval_steps, [
        ref.spec(v, b, cfg=CFG), ref.spec(v, ref.perturbed(b), cfg=CFG),
        ref.spec(v, bd, cfg=CFG, **drop)])[0]
    ranks = td.launch(2, td.retrieval_steps, [
        ref.spec(v, b, cfg=CFG, dp=2),
        ref.spec(v, bd, cfg=CFG, dp=2, **drop)])[0]
    return {"jax": want, "port1": one[0], "envelope": one[:2],
            "drop1": one[2], "dp2": ranks[0], "drop2": ranks[1]}


def test_gradcache_dp2_matches_jax_mesh_and_one_process(runs):
    for want, what in ((runs["jax"], "jax dp2"), (runs["port1"], "port")):
        ref.assert_step_like(runs["dp2"], want, f"gradcache dp2 vs {what}",
                             runs["envelope"])


def test_gradcache_dp2_keeps_the_draws(runs):
    ref.assert_step_like(runs["drop2"], runs["drop1"], "dropout",
                         runs["envelope"])
    np.testing.assert_array_equal(runs["drop2"]["generator"],
                                  runs["drop1"]["generator"])
