"""Image-text retrieval training on Flickr8k: port of
atq_tpu/train/retrieval.py and its CLI, train_multimodal.py.

    python -m atq_tpu_torch.train.retrieval --batch_size 16 --embed_dim 192 \
        --hidden_dim 384 --epochs 10 --learning_rate 5e-5 --image_size 160 \
        --use_residual --reinit_model --gradual_quant --warmup_epochs 2 \
        --contrastive_reg 0.05

One step, as the JAX step:

- raw uint8 images are normalized with the ImageNet statistics and flipped
  at random on the device;
- the model embeds both modalities in training mode (BatchNorm batch
  statistics, dropout 0.1 from the step's generator);
- the loss is the curriculum-weighted hard-negative InfoNCE at the epoch's
  temperature (:func:`pool_loss`), blended with the reference's
  distillation term when a baseline's embeddings are given: the KL of a
  similarity matrix against its own detached softmax, zero in value and
  gradient, kept as the reference has it;
- the update is AdamW with betas (0.9, 0.98) and UNMASKED decoupled weight
  decay: parity-frozen latents, LayerNorm scales, ``temperature`` and the
  fusion (which the step never runs) decay too, unlike the classifier's
  masked chain; or ``sgd`` (decay, then momentum 0.9) or ``adam`` (decay,
  then Adam (0.9, 0.98)). The learning rate is warmup-cosine per step with
  a floor of 0.05; ``--clip_grad`` clips the global norm at 1.0;
- with ``--use_ema`` an EMA of the parameters at decay 0.999.

Each epoch sets the contrastive temperature and curriculum stage and
writes the sparsity schedule into the ``sparsity_target`` buffers
(core/schedules.py). The artifacts are the JAX trainer's, under its keys:
``vocab.json``, ``metrics.jsonl``, ``best_model.npz`` (and
``best_ema_model.npz``), ``checkpoint_epoch_N.npz``, ``final_model.npz``,
``training_history.json`` and ``final_report.json``; a checkpoint serves on
``python -m atq_tpu_torch.serve --task retrieval`` and on serve.py.

``--use_amp`` builds the model with ``compute_dtype=bfloat16`` (the JAX
semantics: float32 latent weights, quantizer, norms and softmax; bf16
matmuls and convolutions). ``--grad_accum_steps N`` > 1 takes the GradCache
step (:func:`_gradcache_step`): the full batch stays the negative pool at
one microbatch's activation memory. Every ``--checkpoint_freq`` epochs the
whole training state goes to ``output_dir/orbax/step_N``
(:func:`retrieval_train_state`, train/checkpoint.py), and ``--resume``
continues from the newest one along the same trajectory.

``--scan_layers`` builds the text stack as the ``ScannedTernaryStack``
(nn/transformer.py: stacked ``layers.scan.layer.*`` parameters, each layer
rematerialized in the backward as JAX's ``remat_layers``, quantized per
layer through the order-statistic kernel; ``hoist_quant`` off, as in JAX);
its artifacts keep JAX's scanned names. ``--imagenet_weights F`` grafts a
torchvision ResNet-18 ``.pth`` (sha256-checked, models/resnet.py) into the
backbone and its BatchNorm statistics before ``--reinit_model``, which then
overwrites the backbone's kernels too, as in the reference and JAX.
``--profile_dir`` traces from before the epoch loop until the run's first
epoch has written its metrics (utils/profile_step.py; each epoch's
training steps lie in a ``train_steps`` span), ``--tensorboard_dir``
writes each epoch's metrics under ``retrieval/`` (utils/tb.py), and the
report's single-sample latency is utils/timing.py's ``sec_per_call``.

``--moe_experts N`` gives each text layer the ternary-expert MoE FFN
(nn/transformer.py, parallel/moe.py) and adds ``moe_aux_weight`` (0.01)
times the mean of the layers' load-balance losses to the loss, as JAX
does; the GradCache step adds it in pass 2, where each microbatch's term
reaches the parameters directly (``aux_scale · moe_aux_weight · aux / N``).

Not ported yet (each raises ``NotImplementedError``, ROADMAP.md queue 1
item 7): ``--dp``/``--tp``/``--fsdp``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from atq_tpu_torch.core.schedules import (
    GradualQuantizationScheduler,
    epoch_progress,
    set_quant_sparsity,
)
from atq_tpu_torch.data.augment import random_hflip
from atq_tpu_torch.data.flickr8k import IMAGENET_MEAN, IMAGENET_STD
from atq_tpu_torch.data.prefetch import PrefetchLoader
from atq_tpu_torch.losses.contrastive import (
    ContrastiveLearningManager,
    HardNegativeMiningInfoNCE,
    MultiPositiveInfoNCE,
    curriculum_weights_traced,
)
from atq_tpu_torch.models.fusion import l2_normalize
from atq_tpu_torch.models.retrieval import (
    ATQMultimodalRetrieval,
    get_model_size_info,
)
from atq_tpu_torch.ops import kernel_launches
from atq_tpu_torch.train.checkpoint import (
    copy_into,
    numpy_rng_state,
    restore_train_state,
    save_train_state,
    set_numpy_rng_state,
    state_digest,
    to_host,
)
from atq_tpu_torch.train.classifier import (
    AdamChain,
    SgdChain,
    _StepClock,
    _to_device,
)
from atq_tpu_torch.train.retrieval_metrics import (
    compute_retrieval_metrics,
    compute_retrieval_metrics_dedup,
)
from atq_tpu_torch.train.schedules_lr import warmup_cosine_schedule
from atq_tpu_torch.utils.jax_interop import (
    from_jax_variables,
    load_checkpoint,
    save_checkpoint,
    to_jax_variables,
)
from atq_tpu_torch.utils.platform import resolve_device
from atq_tpu_torch.utils.profile_step import (
    TRAIN_SPAN,
    start_trace,
    stop_trace,
)
from atq_tpu_torch.utils.tb import MetricsWriter
from atq_tpu_torch.utils.timing import sec_per_call

EMA_DECAY = 0.999


@dataclasses.dataclass
class RetrievalConfig:
    """The train_multimodal.py surface, field for field (the JAX
    ``RetrievalConfig``); ``device`` defaults to the GPU."""

    seed: int = 42
    use_cuda: bool = False
    device: str = "cuda"
    output_dir: str = "./outputs/retrieval"
    verbose: bool = False
    num_workers: int = 2
    batch_size: int = 16
    max_seq_length: int = 50
    image_size: int = 160
    embed_dim: int = 192
    hidden_dim: int = 384
    vision_sparsity: float = 0.3
    text_sparsity: float = 0.2
    use_residual: bool = False
    reinit_model: bool = False
    gradual_quant: bool = False
    warmup_epochs: int = 2
    epochs: int = 10
    learning_rate: float = 5e-5
    weight_decay: float = 1e-4
    optimizer: str = "adamw"
    clip_grad: bool = False
    modality_dropout: float = 0.1
    checkpoint_freq: int = 2
    contrastive_reg: float = 0.02
    use_amp: bool = False
    use_ema: bool = False
    train_baseline: bool = False
    distill: bool = False
    distill_weight: float = 0.3
    grad_checkpointing: bool = False
    data_dir: str = "./data/flickr8k"
    grad_mode: str = "parity"
    dp: Optional[int] = None
    tp: int = 1
    tensorboard_dir: Optional[str] = None
    fsdp: bool = False
    synthetic_images: int = 400
    resume: bool = False
    profile_dir: Optional[str] = None
    vocab_file: Optional[str] = None
    imagenet_weights: Optional[str] = None
    device_preprocess: bool = True
    use_multi_positive: bool = False
    moe_experts: int = 0
    scan_layers: bool = False
    attn_impl: str = "einsum"
    moe_aux_weight: float = 0.01
    grad_accum_steps: int = 1


def _check_supported(cfg: RetrievalConfig) -> None:
    if cfg.dp not in (None, 1) or cfg.tp != 1 or cfg.fsdp:
        raise NotImplementedError(
            "dp/tp/fsdp parallelism (slice H2) is not ported to "
            "atq_tpu_torch yet (ROADMAP.md queue 1)")


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """Raw uint8 NHWC -> ImageNet-normalized float32, on its device."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def _aux_mean(aux) -> Optional[torch.Tensor]:
    """The mean of the load-balance losses the MoE layers appended to
    ``aux`` (None without MoE), as JAX's ``_aux_mean`` averages the sown
    ones."""
    if aux is None:
        return None
    if not aux:
        return torch.zeros(())
    return sum(aux) / len(aux)


def pool_loss(img_emb, txt_emb, temperature, curriculum_kind,
              baseline_embeds, image_ids, cfg: RetrievalConfig, criterion,
              moe_aux_mean=None):
    """The retrieval loss of float32 embeddings: the curriculum-weighted
    hard-negative InfoNCE (the weights keep the similarity's gradient), or
    multi-positive InfoNCE over the image-id positives, plus
    ``moe_aux_weight · moe_aux_mean`` with MoE, then the distillation blend
    when ``baseline_embeds`` is given."""
    if cfg.use_multi_positive:
        positive = (image_ids[:, None] == image_ids[None, :]).float()
        loss = MultiPositiveInfoNCE(lambda_reg=cfg.contrastive_reg)(
            img_emb, txt_emb, positive, temperature=temperature)
    else:
        similarity = torch.matmul(l2_normalize(img_emb),
                                  l2_normalize(txt_emb).T)
        weights = curriculum_weights_traced(similarity, curriculum_kind)
        loss = criterion(img_emb, txt_emb, weights, temperature=temperature)
    if cfg.moe_experts > 0:
        loss = loss + cfg.moe_aux_weight * moe_aux_mean
    if baseline_embeds is not None:
        base_img, base_txt = baseline_embeds
        temp = 3.0

        def kl_self(sim):
            target = torch.softmax(sim.detach(), dim=1)
            log_t = torch.log_softmax(sim.detach(), dim=1)
            log_s = torch.log_softmax(sim, dim=1)
            return torch.mean(torch.sum(target * (log_t - log_s),
                                        dim=1)) * temp ** 2

        distill = (kl_self(torch.matmul(img_emb, base_img.T) / temp)
                   + kl_self(torch.matmul(txt_emb, base_txt.T) / temp)) / 2
        loss = ((1 - cfg.distill_weight) * loss
                + cfg.distill_weight * distill)
    return loss


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def reinit_params(params: Dict, generator: torch.Generator) -> Dict:
    """``--reinit_model`` on a JAX-layout param tree (numpy leaves), by its
    names and fans: ``embedding`` -> N(0, 0.02); a ``weight`` (out, in) or
    ``kernel`` ((in, out), or HWIO with the receptive field in both fans)
    of 2+ dims -> xavier-uniform with gain 0.8 (a scanned stack's leading
    layer axis is no fan); other ``weight``/``kernel`` -> N(0, 0.02);
    ``bias`` -> 0; every other leaf (LayerNorm and BatchNorm scales, alphas,
    gates, scalars) as it is. Values are drawn from ``generator``."""
    new: Dict = {}
    for keys, leaf in _leaves(params):
        name, shape = keys[-1], np.shape(leaf)
        if name == "embedding" or (name in ("weight", "kernel")
                                   and len(shape) < 2):
            leaf = (0.02 * torch.randn(shape, generator=generator)).numpy()
        elif name in ("weight", "kernel"):
            fan_in, fan_out = shape[-1], int(np.prod(shape[:-1]))
            if name == "weight" and len(shape) == 3 and "scan" in keys:
                fan_out = shape[-2]
            if name == "kernel" and len(shape) > 2:  # conv HWIO
                rf = int(np.prod(shape[:-2]))
                fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
            bound = 0.8 * np.sqrt(6.0 / (fan_in + fan_out))
            leaf = torch.empty(shape).uniform_(
                -bound, bound, generator=generator).numpy()
        elif name == "bias":
            leaf = np.zeros_like(leaf)
        node = new
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[name] = leaf
    return new


def reinit_model_(model: torch.nn.Module, generator: torch.Generator):
    """:func:`reinit_params` applied to a model through its JAX layout."""
    variables = to_jax_variables(model.state_dict())
    variables["params"] = reinit_params(variables["params"], generator)
    model.load_state_dict(from_jax_variables(variables))


def graft_imagenet_backbone_(model: torch.nn.Module, path: str,
                             arch: str = "resnet18") -> None:
    """The torchvision ``.pth`` at ``path`` (sha256-checked) as the image
    encoder's backbone: its parameters and BatchNorm statistics, through
    the JAX layout as atq_tpu/train/retrieval.py grafts them."""
    from atq_tpu_torch.models.resnet import load_imagenet_weights

    bb_params, bb_stats = load_imagenet_weights(path, arch=arch)
    variables = to_jax_variables(model.state_dict())
    variables["params"]["image_encoder"]["base_model"] = bb_params
    variables["batch_stats"]["image_encoder"]["base_model"] = bb_stats
    model.load_state_dict(from_jax_variables(variables))


def retrieval_sparsity_plan(cfg: RetrievalConfig) -> Dict[str, tuple]:
    """The model's effective own ramps: the two joint-space projectors."""
    return {
        "text_projector": (min(0.1, cfg.text_sparsity), cfg.text_sparsity),
        "image_projector": (min(0.1, cfg.vision_sparsity),
                            cfg.vision_sparsity),
    }


def make_retrieval_optimizer(cfg: RetrievalConfig, named_params,
                             steps_per_epoch: int):
    total_steps = cfg.epochs * steps_per_epoch
    schedule = warmup_cosine_schedule(cfg.learning_rate,
                                      int(total_steps * 0.1), total_steps,
                                      min_factor=0.05)
    clip = 1.0 if cfg.clip_grad else None
    if cfg.optimizer == "adamw":
        return AdamChain(named_params, schedule, clip_norm=clip,
                         decoupled_weight_decay=cfg.weight_decay, b2=0.98)
    if cfg.optimizer == "sgd":
        return SgdChain(named_params, schedule, clip_norm=clip,
                        weight_decay=cfg.weight_decay, momentum=0.9)
    return AdamChain(named_params, schedule, clip_norm=clip,
                     weight_decay=cfg.weight_decay, b2=0.98)


def _batchnorm_stats(model: torch.nn.Module):
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def _train_forward(model, generator, images, captions, lengths, moe: bool,
                   remat: bool):
    """The training forward: ``(img, txt, moe_aux_mean)``, the last None
    without MoE. With ``remat`` it runs under ``torch.utils.checkpoint``:
    the recompute in the backward replays the dropout generator from the
    same state, so it draws the same masks and the gradients are those of
    the plain forward, and its MoE losses go to a list of its own, so none
    counts twice."""
    def forward(images, captions, lengths):
        aux = [] if moe else None
        img, txt = model(images, captions, lengths, return_embeddings=True,
                         train=True, generator=generator, moe_aux=aux)
        return img, txt, _aux_mean(aux)

    if not remat:
        return forward(images, captions, lengths)
    start = generator.get_state() if generator is not None else None

    def replayed(images, captions, lengths):
        if generator is not None:
            generator.set_state(start)
        return forward(images, captions, lengths)

    return checkpoint(replayed, images, captions, lengths,
                      use_reentrant=False)


def build_retrieval_train_step(model, optimizer, criterion,
                               cfg: RetrievalConfig,
                               generator: Optional[torch.Generator] = None,
                               ema_params=None):
    """``train_step(batch, temperature, curriculum_kind,
    baseline_embeds=None) -> loss`` (a device tensor). ``generator`` draws
    the flips and the dropout masks; ``ema_params`` (a list aligned with
    ``model.parameters()``) is moved towards the updated parameters. With
    ``cfg.grad_accum_steps`` > 1 the step is :func:`_gradcache_step`'s."""
    params = list(model.parameters())

    def prepare(images):
        if images.dtype == torch.uint8:
            images = random_hflip(normalize_images(images), generator)
        return images

    def update():
        optimizer.step()
        if ema_params is not None:
            with torch.no_grad():
                torch._foreach_mul_(ema_params, EMA_DECAY)
                torch._foreach_add_(ema_params, torch._foreach_mul(
                    params, 1 - EMA_DECAY))

    def train_step(batch, temperature, curriculum_kind,
                   baseline_embeds=None):
        images, captions, lengths = batch[:3]
        image_ids = batch[3] if cfg.use_multi_positive else None
        images = prepare(images)
        model.zero_grad(set_to_none=True)
        img_emb, txt_emb, moe_aux = _train_forward(
            model, generator, images, captions, lengths,
            cfg.moe_experts > 0, cfg.grad_checkpointing)
        if cfg.grad_checkpointing:
            # The recompute moves BatchNorm's running statistics again.
            stats = _batchnorm_stats(model)
            saved = [s.clone() for s in stats]
        loss = pool_loss(img_emb.float(), txt_emb.float(), temperature,
                         curriculum_kind, baseline_embeds, image_ids, cfg,
                         criterion, moe_aux)
        loss.backward()
        if cfg.grad_checkpointing:
            with torch.no_grad():
                torch._foreach_copy_(stats, saved)
        update()
        return loss.detach()

    def gradcache_step(batch, temperature, curriculum_kind,
                       baseline_embeds=None):
        loss = _gradcache_step(model, criterion, cfg, generator, prepare,
                               batch, temperature, curriculum_kind,
                               baseline_embeds)
        update()
        return loss

    return train_step if cfg.grad_accum_steps <= 1 else gradcache_step


def _gradcache_step(model, criterion, cfg: RetrievalConfig, generator,
                    prepare, batch, temperature, curriculum_kind,
                    baseline_embeds):
    """GradCache (Gao et al., "Scaling Deep Contrastive Learning Batch Size
    under Memory Limited Setup"), as the JAX step
    (atq_tpu/train/retrieval.py:381-533): the loss keeps the whole batch
    as its negative pool while activations live one microbatch at a time.
    Leaves in every parameter's ``.grad`` the gradient of the full-pool
    loss and returns the loss.

    - Pass 1 embeds the ``N = cfg.grad_accum_steps`` microbatches in turn
      without gradients; BatchNorm's running statistics move through them
      in order (the JAX scan's carry), and the generator's state before
      each microbatch is kept.
    - The full-pool :func:`pool_loss` of the float32 embeddings (with the
      whole batch's ``baseline_embeds`` and image ids) and its gradient
      with respect to them.
    - Pass 2 re-encodes each microbatch from its kept generator state (the
      same flips and dropout masks as pass 1) and backpropagates its slice
      of that gradient; ``.grad`` sums the N microbatches. There is no
      1/N: the slices already carry it. With MoE, pass 1's loss holds the
      mean of the microbatches' aux means, and pass 2 backpropagates each
      microbatch's ``aux_scale · moe_aux_weight · aux / N`` besides (JAX's
      surrogate; ``aux_scale`` is ``1 − distill_weight`` with a baseline,
      the blend's factor, else 1). Train-mode BatchNorm normalizes
      with batch statistics, so pass 2's outputs do not depend on the
      running statistics it moves; they are set back to pass 1's final
      ones, and the generator to its state after pass 1.

    A batch that N does not divide raises ``ValueError``, as in JAX."""
    images, captions, lengths = batch[:3]
    image_ids = batch[3] if cfg.use_multi_positive else None
    n_accum = cfg.grad_accum_steps
    total = images.shape[0]
    if total % n_accum:
        raise ValueError(f"batch size {total} not divisible by "
                         f"grad_accum_steps {n_accum}")
    micro = total // n_accum
    parts = [slice(i * micro, (i + 1) * micro) for i in range(n_accum)]

    def replay(state):
        if generator is not None:
            generator.set_state(state)

    moe = cfg.moe_experts > 0
    starts, img_parts, txt_parts, aux_parts = [], [], [], []
    with torch.no_grad():
        for part in parts:
            starts.append(generator.get_state() if generator is not None
                          else None)
            img, txt, aux = _train_forward(
                model, generator, prepare(images[part]), captions[part],
                lengths[part], moe, remat=False)
            img_parts.append(img.float())
            txt_parts.append(txt.float())
            aux_parts.append(aux)
    end = generator.get_state() if generator is not None else None
    stats = _batchnorm_stats(model)
    final_stats = [s.clone() for s in stats]

    img_emb = torch.cat(img_parts).requires_grad_()
    txt_emb = torch.cat(txt_parts).requires_grad_()
    moe_aux = torch.stack(aux_parts).mean() if moe else None
    loss = pool_loss(img_emb, txt_emb, temperature, curriculum_kind,
                     baseline_embeds, image_ids, cfg, criterion, moe_aux)
    cot_img, cot_txt = torch.autograd.grad(loss, (img_emb, txt_emb))
    aux_scale = (1.0 - cfg.distill_weight if baseline_embeds is not None
                 else 1.0)

    model.zero_grad(set_to_none=True)
    for part, start in zip(parts, starts):
        replay(start)
        img, txt, aux = _train_forward(
            model, generator, prepare(images[part]), captions[part],
            lengths[part], moe, cfg.grad_checkpointing)
        outs = [img.float(), txt.float()]
        grads = [cot_img[part], cot_txt[part]]
        if moe:  # reaches the parameters directly, not via the embeddings
            outs.append(aux_scale * cfg.moe_aux_weight * aux / n_accum)
            grads.append(torch.ones_like(outs[-1]))
        torch.autograd.backward(outs, grads)
    with torch.no_grad():
        torch._foreach_copy_(stats, final_stats)
    replay(end)
    return loss.detach()


def build_baseline_train_step(baseline_model, baseline_optimizer, criterion,
                              generator: Optional[torch.Generator] = None):
    """The full-precision baseline's step: one contrastive update, then the
    updated model's eval-mode embeddings of the batch (for distillation).
    Returns ``step(batch, temperature) -> (loss, (img, txt))``."""

    def step(batch, temperature):
        images, captions, lengths = batch[:3]
        if images.dtype == torch.uint8:
            images = random_hflip(normalize_images(images), generator)
        baseline_model.zero_grad(set_to_none=True)
        img, txt = baseline_model(images, captions, lengths,
                                  return_embeddings=True, train=True)
        loss = criterion(img, txt, temperature=temperature)
        loss.backward()
        baseline_optimizer.step()
        with torch.no_grad():
            embeds = baseline_model(images, captions, lengths,
                                    return_embeddings=True, train=False)
        return loss.detach(), embeds

    return step


@contextlib.contextmanager
def _swapped_in(params, values):
    """``params`` hold ``values`` inside the block, their own after it."""
    with torch.no_grad():
        saved = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, values)
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_(params, saved)


def build_embed_fn(model, ema_params=None):
    """``embed(batch, use_ema=False) -> (image, text)`` embeddings in eval
    mode (dense), from the EMA parameters when asked."""
    params = list(model.parameters())

    @torch.no_grad()
    def embed(batch, use_ema: bool = False):
        images, captions, lengths = batch[:3]
        if images.dtype == torch.uint8:
            images = normalize_images(images)
        ctx = (_swapped_in(params, ema_params) if use_ema
               else contextlib.nullcontext())
        with ctx:
            return model(images, captions, lengths, return_embeddings=True,
                         train=False)

    return embed


def _batch_to(batch, device):
    """A host batch on ``device``: images as they are (uint8 or float32),
    token ids, lengths and image ids as int64."""
    images, *rest = batch
    return (_to_device(images, device),
            *(_to_device(np.asarray(a), device).long() for a in rest))


def evaluate_model(embed_fn, loader, device, topk=(1, 5, 10),
                   use_ema: bool = False):
    """Embed every batch, score the full similarity matrix on the host,
    R@K in both directions plus the unique-gallery text-to-image recalls."""
    all_img, all_txt = [], []
    for batch in loader:
        img, txt = embed_fn(_batch_to(batch, device), use_ema)
        all_img.append(img.cpu().numpy())
        all_txt.append(txt.cpu().numpy())
    all_img = np.concatenate(all_img)
    all_txt = np.concatenate(all_txt)
    metrics = compute_retrieval_metrics(all_img @ all_txt.T, topk=list(topk))
    metrics.update(compute_retrieval_metrics_dedup(all_img, all_txt,
                                                   topk=list(topk)))
    return metrics


def _variables(model, params=None, collections=None) -> Dict:
    """The model's JAX-layout variables, with ``params`` (aligned with
    ``model.parameters()``) in place of its own when given."""
    sd = model.state_dict()
    if params is not None:
        for (name, _), value in zip(model.named_parameters(), params):
            sd[name] = value
    out = to_jax_variables(sd)
    if collections is not None:
        out = {k: v for k, v in out.items() if k in collections}
    return out


def retrieval_train_state(model, optimizer, ema, baseline, baseline_opt,
                          generators, train_loader, epoch: int,
                          best_val_r1: float) -> Dict:
    """Everything a resumed run needs to go on along the same trajectory
    (the live tensors; checkpoint.py's ``save_train_state`` writes it):
    the model's parameters and buffers (quant, BatchNorm, constants), the
    optimizer's count and moments, the EMA, the co-trained baseline and its
    optimizer, the epochs done, the best validation R@1, the state of
    every stateful generator, the train loader's epoch (its shuffle) and
    numpy's global RNG."""
    state = {"epoch": epoch, "best_val_r1": float(best_val_r1),
             "model": model.state_dict(),
             "optimizer": optimizer.state_dict(),
             "generators": {k: g.get_state() for k, g in generators.items()},
             "loader_epoch": getattr(train_loader, "epoch", None),
             "numpy_rng": numpy_rng_state()}
    if ema is not None:
        state["ema_params"] = list(ema)
    if baseline is not None:
        state["baseline"] = baseline.state_dict()
        state["baseline_optimizer"] = baseline_opt.state_dict()
    return state


def load_retrieval_train_state(state: Dict, model, optimizer, ema, baseline,
                               baseline_opt, generators,
                               train_loader) -> None:
    """Put :func:`retrieval_train_state`'s values into the live objects,
    bit for bit (the epoch and best R@1 are the caller's)."""
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    if (ema is None) != ("ema_params" not in state) or \
            (baseline is None) != ("baseline" not in state):
        raise ValueError("the saved training state was written with other "
                         "--use_ema / --train_baseline flags")
    if ema is not None:
        copy_into(ema, state["ema_params"])
    if baseline is not None:
        baseline.load_state_dict(state["baseline"])
        baseline_opt.load_state_dict(state["baseline_optimizer"])
    if sorted(state["generators"]) != sorted(generators):
        raise ValueError("the saved generators are "
                         f"{sorted(state['generators'])}, this run has "
                         f"{sorted(generators)}")
    for k, g in generators.items():
        g.set_state(state["generators"][k])
    if state["loader_epoch"] is not None:
        train_loader.epoch = state["loader_epoch"]
    set_numpy_rng_state(state["numpy_rng"])


def optax_state_tree(cfg: RetrievalConfig, optimizer, model) -> Dict:
    """The optimizer's state under the paths of the JAX trainer's optax
    chain (``checkpoint_epoch_N.npz``'s ``optimizer_state_dict``): the
    clip (when on) is element 0 of the outer chain, then adamw's
    ``(ScaleByAdamState, _, ScaleByScheduleState)``, sgd's
    ``(_, ((TraceState,), ScaleByScheduleState))`` or adam's
    ``(_, ScaleByAdamState, ScaleByScheduleState)``; moments in the
    params' JAX layout, counts int32."""
    count = np.asarray(optimizer.count, np.int32)

    def tree(moments):
        return _variables(model, moments)["params"]

    if cfg.optimizer == "sgd":
        inner = {"1": {"0": {"trace": tree(optimizer.trace)},
                       "1": {"count": count}}}
    else:
        adam = {"count": count, "mu": tree(optimizer.mu),
                "nu": tree(optimizer.nu)}
        inner = {"0" if cfg.optimizer == "adamw" else "1": adam,
                 "2": {"count": count}}
    return {"1" if cfg.clip_grad else "0": inner}


def train_retrieval(cfg: RetrievalConfig, loaders=None, verbose=True):
    """Full training run; returns ``(state, history, report)`` as the JAX
    trainer does. ``state`` holds the model, its optimizer, the EMA
    parameters, the baseline and ``stats`` (per epoch: seconds, pairs/s,
    step losses, step-to-step ms and kernel launches per step; with
    ``profile_dir``, ``profile_launches``: the launches in the traced
    window)."""
    from atq_tpu_torch.data.flickr8k import (
        prepare_flickr8k_dataloaders,
        save_vocab_file,
    )

    _check_supported(cfg)
    device = resolve_device(cfg.device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    np.random.seed(cfg.seed)
    if loaders is None:
        loaders = prepare_flickr8k_dataloaders(
            batch_size=cfg.batch_size, image_size=cfg.image_size,
            max_length=cfg.max_seq_length, tokenize_captions=True,
            num_workers=cfg.num_workers, root_dir=cfg.data_dir,
            synthetic_images=cfg.synthetic_images,
            vocab_file=cfg.vocab_file, raw_uint8=cfg.device_preprocess,
            with_image_ids=cfg.use_multi_positive)
    train_loader, val_loader, test_loader, vocab_size, word_to_idx = loaders
    save_vocab_file(word_to_idx, os.path.join(cfg.output_dir, "vocab.json"))

    model = ATQMultimodalRetrieval(
        vocab_size=vocab_size, embed_dim=cfg.embed_dim,
        hidden_dim=cfg.hidden_dim, vision_threshold=cfg.vision_sparsity,
        text_threshold=cfg.text_sparsity, use_residual=cfg.use_residual,
        grad_mode=cfg.grad_mode, max_seq_length=cfg.max_seq_length,
        text_moe_experts=cfg.moe_experts, text_scan_layers=cfg.scan_layers,
        text_attn_impl=cfg.attn_impl,
        compute_dtype=torch.bfloat16 if cfg.use_amp else None,
        device=device, generator=torch.Generator().manual_seed(cfg.seed))
    if cfg.imagenet_weights:
        # Before the re-init, as the reference and JAX do it: the re-init
        # then overwrites the pretrained backbone's kernels too.
        graft_imagenet_backbone_(model, cfg.imagenet_weights)
        if verbose:
            print(f"Loaded IMAGENET1K backbone from {cfg.imagenet_weights}")
        if cfg.reinit_model and verbose:
            print("WARNING: --reinit_model re-initializes the pretrained "
                  "backbone too (reference parity quirk)")
    if cfg.reinit_model:
        if verbose:
            print("Reinitializing model weights...")
        reinit_model_(model, torch.Generator().manual_seed(cfg.seed + 99))
    model_info = get_model_size_info(_variables(model)["params"],
                                     use_rpb=cfg.use_residual)
    if verbose:
        print("Model information:")
        for k, v in model_info.items():
            print(f"  {k}: {v:,}" if isinstance(v, int) else
                  f"  {k}: {v:.2f}")

    criterion = HardNegativeMiningInfoNCE(
        temperature=0.07, lambda_reg=cfg.contrastive_reg,
        hard_negative_weight=0.5, temperature_schedule=True)
    cl_manager = ContrastiveLearningManager(criterion=criterion,
                                            similarity_threshold=0.7)
    quant_scheduler = None
    if cfg.gradual_quant:
        quant_scheduler = GradualQuantizationScheduler(
            cfg.epochs, vision_sparsity=cfg.vision_sparsity,
            text_sparsity=cfg.text_sparsity,
            warmup_epochs=cfg.warmup_epochs, verbose=cfg.verbose)
    sparsity_plan = retrieval_sparsity_plan(cfg)

    steps_per_epoch = max(1, len(train_loader))
    optimizer = make_retrieval_optimizer(cfg, model.named_parameters(),
                                         steps_per_epoch)
    ema = ([p.detach().clone() for p in model.parameters()]
           if cfg.use_ema else None)
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)

    generators = {"step": step_gen}
    baseline = baseline_opt = baseline_step = None
    if cfg.train_baseline:
        from atq_tpu_torch.models.baseline_retrieval import (
            BaselineRetrievalModel,
        )

        if verbose:
            print("Creating baseline retrieval model...")
        baseline = BaselineRetrievalModel(
            vocab_size=vocab_size, embed_dim=cfg.embed_dim,
            hidden_dim=cfg.hidden_dim, device=device,
            generator=torch.Generator().manual_seed(cfg.seed + 5))
        # The reference always trains the baseline with plain AdamW.
        baseline_opt = AdamChain(baseline.named_parameters(),
                                 lambda _: cfg.learning_rate,
                                 decoupled_weight_decay=cfg.weight_decay)
        generators["baseline"] = torch.Generator(
            device=device).manual_seed(cfg.seed + 11)
        baseline_step = build_baseline_train_step(
            baseline, baseline_opt, criterion, generators["baseline"])

    train_step = build_retrieval_train_step(model, optimizer, criterion, cfg,
                                            step_gen, ema)
    embed_fn = build_embed_fn(model, ema)

    best_val_r1 = 0.0
    train_losses, val_history, pairs_per_sec_hist = [], [], []
    stats = {"epoch_seconds": [], "step_losses": [], "step_ms": [],
             "launches_per_step": []}
    metrics_path = os.path.join(cfg.output_dir, "metrics.jsonl")
    core = ("params", "quant", "constants", "batch_stats")

    def train_state(epoch):
        return retrieval_train_state(model, optimizer, ema, baseline,
                                     baseline_opt, generators, train_loader,
                                     epoch, best_val_r1)

    orbax_dir = os.path.join(cfg.output_dir, "orbax")
    start_epoch = 0
    if cfg.resume:
        try:
            saved, start_epoch = restore_train_state(orbax_dir)
        except FileNotFoundError:
            if verbose:
                print("No checkpoint to resume from; starting fresh")
        else:
            load_retrieval_train_state(saved, model, optimizer, ema,
                                       baseline, baseline_opt, generators,
                                       train_loader)
            best_val_r1 = saved["best_val_r1"]
            if verbose:
                print(f"Resumed from {orbax_dir} at epoch {start_epoch}")
                print(f"  Restored training state (sha256 "
                      f"{state_digest(to_host(train_state(start_epoch)))})")

    tb = MetricsWriter(cfg.tensorboard_dir)
    prof = start_trace(cfg.profile_dir, device) if cfg.profile_dir else None
    traced_from = kernel_launches()
    for epoch in range(start_epoch, cfg.epochs):
        criterion.set_epoch(epoch, cfg.epochs)
        cl_manager.set_epoch(epoch, cfg.epochs)
        temperature = criterion.get_current_temperature()
        if quant_scheduler is not None:
            quant_scheduler.step(model, epoch, sparsity_plan)
        else:
            set_quant_sparsity(model, sparsity_plan,
                               epoch_progress(epoch, cfg.epochs))
        # Epoch constants go to the device once, not per step.
        temperature_dev = torch.tensor(temperature, dtype=torch.float32,
                                       device=device)
        curriculum_dev = torch.tensor(cl_manager.curriculum_kind(),
                                      device=device)
        losses, n_pairs = [], 0
        launches0 = kernel_launches()
        clock = _StepClock(device)
        with record_function(TRAIN_SPAN):
            t0 = time.perf_counter()
            for batch in PrefetchLoader(train_loader):
                batch = _batch_to(batch, device)
                baseline_embeds = None
                if baseline_step is not None:
                    _, embeds = baseline_step(batch, temperature_dev)
                    if cfg.distill:
                        baseline_embeds = embeds
                losses.append(train_step(batch, temperature_dev,
                                         curriculum_dev, baseline_embeds))
                clock.mark()
                n_pairs += int(batch[0].shape[0])
            step_ms = clock.step_ms()  # synchronizes on the card
        epoch_time = time.perf_counter() - t0
        launches = kernel_launches()
        stats["launches_per_step"].append(
            {k: (launches[k] - launches0[k]) / max(1, len(losses))
             for k in launches})
        step_losses = torch.stack(losses).cpu().tolist() if losses else []
        stats["step_losses"].append(step_losses)
        stats["step_ms"].append(step_ms)
        stats["epoch_seconds"].append(epoch_time)
        pairs_per_sec = n_pairs / max(epoch_time, 1e-9)
        pairs_per_sec_hist.append(pairs_per_sec)
        train_loss = sum(step_losses) / max(1, len(step_losses))
        train_losses.append(train_loss)

        val_metrics = evaluate_model(embed_fn, val_loader, device,
                                     use_ema=cfg.use_ema)
        val_history.append(val_metrics)
        if verbose:
            print(f"Epoch {epoch + 1}/{cfg.epochs} - {epoch_time:.1f}s "
                  f"({pairs_per_sec:.1f} pairs/s):")
            print(f"  Train Loss: {train_loss:.4f}")
            for k in (1, 5, 10):
                print(f"  Validation R@{k}: "
                      f"{val_metrics[f'mean_R@{k}']:.2f}%")
        if val_metrics["mean_R@1"] > best_val_r1:
            best_val_r1 = val_metrics["mean_R@1"]
            if verbose:
                print(f"  New best model with validation R@1: "
                      f"{best_val_r1:.2f}%")
            save_checkpoint(_variables(model, collections=core),
                            os.path.join(cfg.output_dir, "best_model.npz"))
            if cfg.use_ema:
                save_checkpoint(
                    _variables(model, ema, collections=core),
                    os.path.join(cfg.output_dir, "best_ema_model.npz"))
        epoch_metrics = {"train_loss": float(train_loss),
                         "pairs_per_sec": float(pairs_per_sec),
                         **{k: float(v) for k, v in val_metrics.items()}}
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"epoch": epoch + 1, **epoch_metrics}) + "\n")
        tb.scalars(epoch + 1, epoch_metrics, prefix="retrieval/")
        tb.flush()
        if prof is not None and epoch == start_epoch:
            stop_trace(prof, device)
            prof = None
            now = kernel_launches()
            stats["profile_launches"] = {k: now[k] - traced_from[k]
                                         for k in now}
        if (epoch + 1) % cfg.checkpoint_freq == 0 \
                or (epoch + 1) == cfg.epochs:
            host = to_host(train_state(epoch + 1))
            state_path = save_train_state(orbax_dir, epoch + 1, host)
            if verbose:
                print(f"  Saved training state to {state_path} (sha256 "
                      f"{state_digest(host)})")
            ckpt_path = os.path.join(cfg.output_dir,
                                     f"checkpoint_epoch_{epoch + 1}.npz")
            save_checkpoint({
                "epoch": np.asarray(epoch + 1),
                "model_state_dict": _variables(
                    model, collections=("params", "quant", "batch_stats")),
                "optimizer_state_dict": optax_state_tree(cfg, optimizer,
                                                         model),
                "best_val_r1": np.asarray(best_val_r1),
            }, ckpt_path)
            if verbose:
                print(f"  Saved checkpoint to {ckpt_path}")

    if prof is not None:  # no epoch ran
        stop_trace(prof, device)
    save_checkpoint(_variables(model, collections=core),
                    os.path.join(cfg.output_dir, "final_model.npz"))
    history = {"train_losses": [float(x) for x in train_losses],
               "val_metrics": [{k: float(v) for k, v in m.items()}
                               for m in val_history]}
    with open(os.path.join(cfg.output_dir, "training_history.json"),
              "w") as f:
        json.dump(history, f, indent=4)
    _plot_training_curves(train_losses, val_history, cfg.output_dir)

    best_path = os.path.join(cfg.output_dir, "best_model.npz")
    if os.path.exists(best_path):
        model.load_jax_variables(load_checkpoint(best_path))
        if verbose:
            print(f"Loaded best model from {best_path}")
    test_metrics = evaluate_model(embed_fn, test_loader, device)

    one = (torch.zeros((1, cfg.image_size, cfg.image_size, 3),
                       device=device),
           torch.zeros((1, cfg.max_seq_length), dtype=torch.long,
                       device=device),
           torch.tensor([5], device=device))
    # Single-sample latency by slope timing, as the JAX trainer takes it.
    atq_time_ms = sec_per_call(lambda: embed_fn(one)) * 1000.0
    baseline_time_ms = None
    if baseline is not None:
        def baseline_embed():
            with torch.no_grad():
                return baseline(*one, return_embeddings=True, train=False)

        baseline_time_ms = sec_per_call(baseline_embed) * 1000.0

    report = {
        "best_val_r1": float(best_val_r1),
        "test_metrics": {k: float(v) for k, v in test_metrics.items()},
        "atq_inference_time_ms": float(atq_time_ms),
        "baseline_inference_time_ms": (float(baseline_time_ms)
                                       if baseline_time_ms else None),
        "speed_ratio": (float(baseline_time_ms / atq_time_ms)
                        if baseline_time_ms and atq_time_ms > 0 else None),
        "model_size_mb": float(model_info["estimated_memory_usage_MB"]),
        "parameters": int(model_info["total_parameters"]),
        "pairs_per_sec": (float(np.mean(pairs_per_sec_hist[1:])
                                if len(pairs_per_sec_hist) > 1
                                else pairs_per_sec_hist[0])
                          if pairs_per_sec_hist else None),
        "training_args": dataclasses.asdict(cfg),
    }
    with open(os.path.join(cfg.output_dir, "final_report.json"), "w") as f:
        json.dump(report, f, indent=4)
    if verbose:
        print("=" * 50)
        print("TRAINING COMPLETE")
        print(f"Best validation R@1: {best_val_r1:.2f}%")
        for k in (1, 5, 10):
            print(f"  Test R@{k}: {test_metrics[f'mean_R@{k}']:.2f}%")
        print(f"  ATQ inference time: {atq_time_ms:.2f} ms per sample")
    tb.close()
    state = {"model": model, "optimizer": optimizer, "ema_params": ema,
             "baseline": baseline, "baseline_optimizer": baseline_opt,
             "generators": generators, "embed_fn": embed_fn,
             "stats": {**stats, "pairs_per_sec": pairs_per_sec_hist}}
    return state, history, report


def _plot_training_curves(train_losses, val_history, output_dir) -> None:
    """training_curves.png where matplotlib is installed; otherwise one
    line saying the plots were skipped."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: training_curves.png skipped")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(15, 10))
    plt.subplot(2, 2, 1)
    plt.plot(train_losses)
    plt.title("Training Loss")
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.grid(True)
    plt.subplot(2, 2, 2)
    for k in (1, 5, 10):
        plt.plot([m[f"mean_R@{k}"] for m in val_history], label=f"R@{k}")
    plt.title("Validation Retrieval Performance")
    plt.xlabel("Epoch")
    plt.ylabel("Recall (%)")
    plt.legend()
    plt.grid(True)
    plt.subplot(2, 2, 3)
    plt.plot([m["image_to_text_R@1"] for m in val_history],
             label="Image→Text")
    plt.plot([m["text_to_image_R@1"] for m in val_history],
             label="Text→Image")
    plt.title("R@1 by Direction")
    plt.xlabel("Epoch")
    plt.ylabel("Recall@1 (%)")
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    plt.savefig(os.path.join(output_dir, "training_curves.png"))
    plt.close()


def build_parser() -> argparse.ArgumentParser:
    """train_multimodal.py's flags, one for one; ``--device`` is ``cpu`` or
    ``cuda`` (the default)."""
    p = argparse.ArgumentParser(
        description="Train ATQ model for image-text retrieval")
    add = p.add_argument
    add("--seed", type=int, default=42, help="Random seed")
    add("--use_cuda", action="store_true",
        help="Accepted for compatibility (--device selects the device)")
    add("--device", type=str, default="cuda", choices=["cpu", "cuda"],
        help="Device to use (default: cuda)")
    add("--output_dir", type=str, default="./outputs/retrieval",
        help="Output directory")
    add("--verbose", action="store_true", help="Enable verbose output")
    add("--num_workers", type=int, default=2,
        help="Number of workers for data loading (loading is in-process)")
    add("--batch_size", type=int, default=16, help="Batch size")
    add("--max_seq_length", type=int, default=50,
        help="Maximum sequence length for text")
    add("--image_size", type=int, default=160,
        help="Image size for resizing")
    add("--embed_dim", type=int, default=192,
        help="Embedding dimension for joint space")
    add("--hidden_dim", type=int, default=384,
        help="Hidden dimension for encoders")
    add("--vision_sparsity", type=float, default=0.3,
        help="Sparsity target for vision encoder")
    add("--text_sparsity", type=float, default=0.2,
        help="Sparsity target for text encoder")
    add("--use_residual", action="store_true",
        help="Use residual precision boosting")
    add("--reinit_model", action="store_true",
        help="Reinitialize model weights")
    add("--gradual_quant", action="store_true",
        help="Use gradual quantization schedule")
    add("--warmup_epochs", type=int, default=2,
        help="Number of warmup epochs for quantization")
    add("--epochs", type=int, default=10, help="Number of epochs")
    add("--learning_rate", type=float, default=5e-5, help="Learning rate")
    add("--weight_decay", type=float, default=1e-4, help="Weight decay")
    add("--optimizer", type=str, default="adamw",
        choices=["adam", "adamw", "sgd"], help="Optimizer")
    add("--clip_grad", action="store_true", help="Apply gradient clipping")
    add("--modality_dropout", type=float, default=0.1,
        help="Probability of dropping a modality (unused, as in JAX)")
    add("--checkpoint_freq", type=int, default=2,
        help="Checkpoint save frequency (epochs)")
    add("--contrastive_reg", type=float, default=0.02,
        help="Regularization for contrastive loss")
    add("--use_amp", action="store_true",
        help="Mixed precision: bf16 matmuls and convolutions")
    add("--use_ema", action="store_true",
        help="Use exponential moving average model")
    add("--train_baseline", action="store_true",
        help="Train baseline model for comparison")
    add("--distill", action="store_true", help="Use knowledge distillation")
    add("--distill_weight", type=float, default=0.3,
        help="Weight for distillation loss")
    add("--grad_checkpointing", action="store_true",
        help="Recompute the forward in the backward "
             "(torch.utils.checkpoint)")
    add("--grad_mode", type=str, default="parity",
        choices=["parity", "ste", "ttq"])
    add("--data_dir", type=str, default="./data/flickr8k")
    add("--dp", type=int, default=None,
        help="Data-parallel device count (not ported yet)")
    add("--moe_experts", type=int, default=0,
        help="Ternary-expert MoE FFN in every text layer (0: dense FFN)")
    add("--attn_impl", type=str, default="einsum",
        choices=["einsum", "fused"],
        help="Text-stack attention; 'fused' runs the CUDA kernels only "
             "without dropout, so with the model's dropout of 0.1 training "
             "takes the einsum branch (a one-time warning)")
    add("--scan_layers", action="store_true",
        help="Scanned text stack (stacked layers, rematerialized)")
    add("--grad_accum_steps", type=int, default=1,
        help="GradCache microbatches per step (the full batch stays the "
             "negative pool)")
    add("--fsdp", action="store_true",
        help="Fully-sharded data parallelism (not ported yet)")
    add("--tp", type=int, default=1,
        help="Tensor-parallel size (not ported yet)")
    add("--synthetic_images", type=int, default=400,
        help="Synthetic corpus size when real data missing")
    add("--resume", action="store_true",
        help="Resume from the newest training state in output_dir/orbax")
    add("--profile_dir", type=str, default=None,
        help="Trace the run's first epoch here (torch.profiler)")
    add("--tensorboard_dir", type=str, default=None,
        help="Write TensorBoard scalars here")
    add("--vocab_file", type=str, default=None,
        help="Use a recorded vocabulary JSON")
    add("--use_multi_positive", action="store_true",
        help="Train with MultiPositiveInfoNCE over the 5 captions per image")
    add("--imagenet_weights", type=str, default=None,
        help="torchvision resnet18 IMAGENET1K_V1 .pth for the backbone")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = RetrievalConfig(**{f.name: getattr(args, f.name)
                             for f in dataclasses.fields(RetrievalConfig)
                             if hasattr(args, f.name)})
    return train_retrieval(cfg)


if __name__ == "__main__":
    main()
