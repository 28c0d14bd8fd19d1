"""Classification training (Fashion-MNIST / MNIST): port of
atq_tpu/train/classifier.py.

One step trains both models, as the JAX step does:

- the full-precision teacher (``BaselineCNNClassifier``) first: its
  forward, cross-entropy, backward and update;
- then the ATQ student, distilled from the teacher's *pre-update* logits
  (T = 4, 0.7 CE + 0.3 KD, teacher logits detached), plus the L1 penalty on
  every ``weight`` (BN scales included, as in JAX);
- progressive sparsity ``0.05 + (target − 0.05)·min(1, e / 0.7E)`` written
  into the RPB ``sparsity_target`` buffers each epoch, and L1 weight
  ``l1_factor·min(1, e / 0.5E)``;
- the optimizers are optax's chains, rebuilt in :class:`AdamChain` (and
  :class:`SgdChain` for the retrieval trainer's ``sgd``): the
  student clip-by-global-norm 1.0 (with ``clip_grad``) → masked weight
  decay 1e-4 (not on frozen parity latents) → Adam; the teacher Adam alone.

Raw uint8 batches are normalized and augmented on the device. Metrics
accumulate on the device; the host reads them once per epoch, so no step
waits for the device. On a CUDA device the order statistic runs every step
(the default, dense path), and with ``ATQ_FUSED=1`` the head's forward, dx
and dW/dalpha run as the fused CUDA kernels.

``grad_accum_steps`` N > 1 splits each batch into N microbatches: each
runs the teacher's and then the student's forward and backward from the
pre-update parameters (BatchNorm statistics move through them in order),
the gradients are their mean, and each model takes one update, as the JAX
``accum_train_step``. Every ``orbax_freq`` epochs (and after the last) the
whole training state goes to ``checkpoint_dir/orbax_<dataset>/step_N``
(:func:`classifier_train_state`, train/checkpoint.py); ``resume`` continues
from the newest one along the same trajectory.

``profile_dir`` traces the window JAX traces: from before the epoch loop
until the first epoch of the run (``start_epoch``) has written its
metrics, with ``torch.profiler`` (the card too), as a Chrome trace under
the directory (utils/profile_step.py reads it back; each epoch's training
steps lie in a ``train_steps`` span). ``tensorboard_dir``
writes each epoch's scalars under ``classifier/`` (utils/tb.py).

``dp``/``tp``/``fsdp`` run under torchrun, one process a device
(``torchrun --nproc_per_node N -m atq_tpu_torch.train --dp N``; NCCL on
the card, gloo with ``--device cpu``). ``batch_size`` is the global batch:
each rank trains both models on its rows (of each global microbatch with
``grad_accum_steps``) with the global batch's augmentation and dropout
draws and BatchNorm statistics, and the reduced gradients are the
one-device step's up to float reassociation. ``tp`` shards
``classifier_0``/``classifier_3``'s out-features over the 'model' ranks
(JAX's ``layer_names``), ``fsdp`` the large leaves of both models over the
'data' ranks. The L1 term is the whole model's once. Rank 0 alone prints
and writes files; checkpoints are whole.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.data.augment import classifier_augment
from atq_tpu_torch.data.mnist import FASHION_STATS, MNIST_STATS
from atq_tpu_torch.data.prefetch import PrefetchLoader
from atq_tpu_torch.models.image_classifier import (
    ATQImageClassifier,
    BaselineCNNClassifier,
)
from atq_tpu_torch.ops import kernel_launches
from atq_tpu_torch.parallel.collectives import all_reduce_
from atq_tpu_torch.parallel.mesh import (
    Mesh,
    from_rank0,
    training_mesh,
    world_rank,
)
from atq_tpu_torch.parallel.sharded_model import ShardedModel
from atq_tpu_torch.train.checkpoint import (
    copy_into,
    numpy_rng_state,
    restore_train_state,
    save_train_state,
    set_numpy_rng_state,
    state_digest,
    to_host,
)
from atq_tpu_torch.train.schedules_lr import (
    step_lr_schedule,
    warmup_cosine_schedule,
)
from atq_tpu_torch.utils.jax_interop import (
    load_checkpoint as jax_load_checkpoint,
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


@dataclasses.dataclass
class ClassifierConfig:
    """The train.py surface, field for field, plus the device."""

    dataset: str = "fashion_mnist"
    batch_size: int = 256
    learning_rate: float = 1e-3
    epochs: int = 20
    use_rpb: bool = False
    distill: bool = False
    sparsity: float = 0.3
    wider_layers: bool = False
    use_cosine_lr: bool = False
    l1_factor: float = 1e-5
    use_l1: bool = False
    clip_grad: bool = False
    bit_packing: bool = False
    data_dir: str = "./data"
    checkpoint_dir: str = "checkpoints"
    plots_dir: str = "plots"
    grad_mode: str = "parity"
    seed: int = 0
    dp: Optional[int] = None
    fsdp: bool = False
    tensorboard_dir: Optional[str] = None
    tp: int = 1
    resume: bool = False
    profile_dir: Optional[str] = None
    orbax_freq: int = 5
    device_augment: bool = True
    grad_accum_steps: int = 1
    device: Optional[str] = None  # None: the GPU


TP_LAYERS = ("classifier_0", "classifier_3")  # JAX's layer_names


def _l1_penalty(model: torch.nn.Module) -> torch.Tensor:
    """Σ|p| over every parameter named ``weight``: the quantized layers'
    latent weights, the conv kernels and the BatchNorm scales (the JAX
    leaves ``weight``, ``kernel`` and ``scale``). A tensor-parallel layer's
    shard adds the other shards' sums as a constant: the value is the whole
    layer's, the gradient its own elements'."""
    total = 0
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if name != "weight":
                continue
            term = p.abs().sum()
            shard = getattr(module, "tp", None)
            if shard is not None:
                part = term.detach()
                term = term + (all_reduce_(part.clone(), shard.group) - part)
            total = total + term
    return total


@torch.no_grad()
def _set_all_sparsity(model: torch.nn.Module, value: float) -> None:
    """Write one sparsity into every layer that has the knob."""
    for module in model.modules():
        buf = getattr(module, "sparsity_target", None)
        if isinstance(buf, torch.Tensor):
            buf.fill_(value)


def _cross_entropy(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def _kd_loss(student_logits, teacher_logits, temperature: float = 4.0):
    """KL(softmax(teacher/T) || softmax(student/T))·T², batch mean."""
    t = F.softmax(teacher_logits / temperature, dim=-1)
    log_s = F.log_softmax(student_logits / temperature, dim=-1)
    log_t = F.log_softmax(teacher_logits / temperature, dim=-1)
    return (t * (log_t - log_s)).sum(-1).mean() * temperature ** 2


def ternary_latent_decay_mask(model: torch.nn.Module, grad_mode: str):
    """``{name: decay?}``: False only for the latent weight of a
    TernaryLinear (a layer with ``alpha`` and no ``precision_mask``) in
    parity mode. It gets no gradient, and torch Adam in the reference skips
    it, so it must not decay either; RPB weights decay."""
    mask = {}
    for mod_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = not (
                name == "weight" and hasattr(module, "alpha")
                and grad_mode == "parity"
                and not hasattr(module, "precision_mask"))
    return mask


class _OptaxChain:
    """The gradient transforms in front of an optax update rule:

    - clip: ``g·max_norm/‖g‖`` when the global norm ``‖g‖ ≥ max_norm``
      (``clip_grad_norm_`` differs: it adds 1e-6 to the norm); a sharded
      trainer sets ``global_norm_sq`` so that the norm is the whole
      gradient's, over every rank's blocks;
    - decay: ``g + wd·p`` on the parameters the mask selects (optax's
      ``add_decayed_weights``, the L2 term of torch Adam's
      ``weight_decay``), before the update rule.

    A parameter without a gradient counts as a zero gradient, as in optax
    (so its decay and its moments still apply). Runs on the parameters'
    device with ``torch._foreach`` ops; the host never reads a value.
    ``schedule(i)`` is the learning rate of update ``i`` (from 0).
    ``state_dict``/``load_state_dict`` carry the update count and the
    moments (``MOMENTS``) for a resumable training state.
    """

    MOMENTS = ()

    def __init__(self, named_params, schedule: Callable[[int], float],
                 clip_norm: Optional[float] = None, weight_decay: float = 0.0,
                 decay_mask: Optional[dict] = None):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.decay_idx = ([i for i, (n, _) in enumerate(named)
                           if decay_mask is None or decay_mask[n]]
                          if weight_decay else [])
        self._zeros = [None] * len(self.params)
        self.count = 0
        # A sharded trainer's (parallel/sharded_model.py): the whole
        # gradient's squared norm from this rank's tensors' squared norms.
        self.global_norm_sq = None

    def _grads(self):
        out = []
        for i, p in enumerate(self.params):
            if p.grad is None:
                if self._zeros[i] is None:
                    self._zeros[i] = torch.zeros_like(p)
                out.append(self._zeros[i])
            else:
                out.append(p.grad)
        return out

    def _transformed_grads(self):
        grads = self._grads()
        if self.clip_norm is not None:
            norms = torch._foreach_norm(grads)
            if self.global_norm_sq is None:
                norm = torch.linalg.vector_norm(torch.stack(norms))
            else:
                norm = torch.sqrt(self.global_norm_sq(
                    [n * n for n in norms]))
            keep = norm < self.clip_norm
            one = torch.ones_like(norm)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(norm, self.clip_norm)))
        if self.decay_idx:
            grads = list(grads)
            decayed = torch._foreach_add(
                [grads[i] for i in self.decay_idx],
                [self.params[i] for i in self.decay_idx],
                alpha=self.weight_decay)
            for i, g in zip(self.decay_idx, decayed):
                grads[i] = g
        return grads

    def state_dict(self) -> dict:
        """The update count and the moments (the live tensors)."""
        return {"count": self.count,
                **{k: list(getattr(self, k)) for k in self.MOMENTS}}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s values, bit for bit, onto the
        moments' devices."""
        self.count = int(state["count"])
        for k in self.MOMENTS:
            copy_into(getattr(self, k), state[k])


class AdamChain(_OptaxChain):
    """optax's ``chain(clip_by_global_norm(1.0)?, masked(
    add_decayed_weights(wd))?, adam(schedule, b1, b2, eps))``, step for
    step: Adam with bias correction, ``p −= lr(i)·m̂/(√v̂ + eps)``. With
    ``decoupled_weight_decay`` (``optax.adamw``'s order) the update becomes
    ``m̂/(√v̂ + eps) + wd·p`` before the ``×(−lr)``, on every parameter.
    The betas and eps default to optax's."""

    MOMENTS = ("mu", "nu")

    def __init__(self, named_params, schedule: Callable[[int], float],
                 clip_norm: Optional[float] = None, weight_decay: float = 0.0,
                 decay_mask: Optional[dict] = None,
                 decoupled_weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(named_params, schedule, clip_norm, weight_decay,
                         decay_mask)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.decoupled_weight_decay = decoupled_weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = self._transformed_grads()
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        bc1 = float(1.0 - np.float32(b1) ** np.float32(self.count))
        bc2 = float(1.0 - np.float32(b2) ** np.float32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        if self.decoupled_weight_decay:
            torch._foreach_add_(updates, self.params,
                                alpha=self.decoupled_weight_decay)
        torch._foreach_add_(self.params, updates, alpha=-lr)


class SgdChain(_OptaxChain):
    """optax's ``chain(clip_by_global_norm(1.0)?, add_decayed_weights(wd)?,
    sgd(schedule, momentum))``: the trace ``t = g + momentum·t`` (not
    Nesterov), then ``p −= lr(i)·t``."""

    MOMENTS = ("trace",)

    def __init__(self, named_params, schedule: Callable[[int], float],
                 clip_norm: Optional[float] = None, weight_decay: float = 0.0,
                 momentum: float = 0.9):
        super().__init__(named_params, schedule, clip_norm, weight_decay)
        self.momentum = momentum
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = self._transformed_grads()
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        torch._foreach_add_(self.params, self.trace, alpha=-lr)


def make_optimizer(cfg: ClassifierConfig, named_params, steps_per_epoch: int,
                   weight_decay: float = 0.0, decay_mask=None, clip=None):
    """The JAX ``make_optimizer``: StepLR (gamma 0.5 every E//4 epochs) or
    warmup-cosine, clip at 1.0 when ``clip`` (default ``cfg.clip_grad``;
    the teacher passes False), optional masked decay, Adam."""
    if cfg.use_cosine_lr:
        total_steps = steps_per_epoch * cfg.epochs
        schedule = warmup_cosine_schedule(cfg.learning_rate,
                                          total_steps // 10, total_steps)
    else:
        schedule = step_lr_schedule(cfg.learning_rate, steps_per_epoch,
                                    cfg.epochs // 4)
    clip = cfg.clip_grad if clip is None else clip
    return AdamChain(named_params, schedule, clip_norm=1.0 if clip else None,
                     weight_decay=weight_decay, decay_mask=decay_mask)


def normalize_augment(images: torch.Tensor, dataset: str,
                      generator: torch.Generator) -> torch.Tensor:
    """Raw uint8 NHWC batch -> normalized, augmented float32, on its
    device (rotation ±5°, and flips for Fashion-MNIST)."""
    mean, std = FASHION_STATS if dataset == "fashion_mnist" else MNIST_STATS
    images = (images.float() / 255.0 - mean) / std
    return classifier_augment(images, generator,
                              flip=dataset == "fashion_mnist")


def build_train_step(atq_model, base_model, atq_opt, base_opt,
                     cfg: ClassifierConfig,
                     generator: Optional[torch.Generator] = None,
                     mesh: Optional[Mesh] = None, sharded=None):
    """``train_step(images, labels, l1_weight) -> metrics``: one co-trained
    step (teacher update first, then the student distilled from the
    teacher's pre-update logits). ``generator`` drives augmentation and
    dropout. After the call each parameter's ``.grad`` holds this step's
    gradient; the metrics are device tensors. With ``cfg.grad_accum_steps``
    N > 1 the step is ``accum_train_step`` (the module docstring); a batch
    that N does not divide raises ``ValueError``, as in JAX.

    Over a ``mesh`` the batch is the global one: each rank runs its rows
    (of each global microbatch, with N > 1) under :meth:`Mesh.data_shard`,
    ``sharded`` (the student's and the teacher's ``ShardedModel``) reduces
    each model's gradients before its update, and the metrics are the
    global batch's (the losses averaged, the counts summed)."""
    mesh = mesh or Mesh(1, 1)
    atq_sh, base_sh = sharded if sharded is not None else (None, None)

    def reduce_and_step(model_sh, opt):
        if model_sh is not None:
            model_sh.reduce_grads()
        opt.step()
        if model_sh is not None:
            model_sh.release()

    def gather():
        for model_sh in (atq_sh, base_sh):
            if model_sh is not None:
                model_sh.gather()

    def global_metrics(m):
        if mesh.shape["data"] == 1:
            return m
        keys = sorted(m)
        packed = torch.stack([m[k].float() for k in keys])
        all_reduce_(packed, mesh.group("data"))
        return {k: (packed[i] / mesh.shape["data"] if "loss" in k
                    else packed[i].to(m[k].dtype))
                for i, k in enumerate(keys)}

    def student_loss(images, labels, base_logits, l1_weight):
        logits = atq_model(images, generator=generator)
        loss = _cross_entropy(logits, labels)
        if cfg.distill:
            loss = 0.7 * loss + 0.3 * _kd_loss(logits, base_logits.detach())
        if cfg.use_l1:
            loss = loss + l1_weight * _l1_penalty(atq_model)
        return loss, logits

    def prepare(images):
        if cfg.device_augment and images.dtype == torch.uint8:
            # Only raw uint8 batches; float batches are already normalized.
            images = normalize_augment(images, cfg.dataset, generator)
        return images

    def train_step(images, labels, l1_weight):
        images, labels = mesh.rows(images), mesh.rows(labels)
        gather()
        with mesh.data_shard():
            images = prepare(images)
            base_model.zero_grad(set_to_none=True)
            base_logits = base_model(images, generator=generator)
            base_loss = _cross_entropy(base_logits, labels)
            base_loss.backward()
        reduce_and_step(base_sh, base_opt)

        with mesh.data_shard():
            atq_model.zero_grad(set_to_none=True)
            loss, logits = student_loss(images, labels, base_logits,
                                        l1_weight)
            loss.backward()
        reduce_and_step(atq_sh, atq_opt)
        return global_metrics({
            "loss": loss.detach(),
            "base_loss": base_loss.detach(),
            "atq_correct": (logits.argmax(-1) == labels).sum(),
            "base_correct": (base_logits.argmax(-1) == labels).sum(),
        })

    n_accum = cfg.grad_accum_steps

    def accum_train_step(images, labels, l1_weight):
        total = images.shape[0]
        if total % n_accum:
            raise ValueError(f"batch size {total} not divisible by "
                             f"grad_accum_steps {n_accum}")
        micro = total // n_accum
        gather()
        base_model.zero_grad(set_to_none=True)
        atq_model.zero_grad(set_to_none=True)
        sums = None
        for i in range(n_accum):
            part = slice(i * micro, (i + 1) * micro)
            with mesh.data_shard():
                x = prepare(mesh.rows(images[part]))
                y = mesh.rows(labels[part])
                base_logits = base_model(x, generator=generator)
                base_loss = _cross_entropy(base_logits, y)
                # .grad sums the microbatches: each backward carries 1/N.
                (base_loss / n_accum).backward()
                loss, logits = student_loss(x, y, base_logits, l1_weight)
                (loss / n_accum).backward()
            m = {"loss": loss.detach() / n_accum,
                 "base_loss": base_loss.detach() / n_accum,
                 "atq_correct": (logits.argmax(-1) == y).sum(),
                 "base_correct": (base_logits.argmax(-1) == y).sum()}
            sums = m if sums is None else {k: sums[k] + v
                                           for k, v in m.items()}
        reduce_and_step(base_sh, base_opt)
        reduce_and_step(atq_sh, atq_opt)
        return global_metrics(sums)

    return train_step if n_accum <= 1 else accum_train_step


def _to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host batch on ``device``. On the card it goes through pinned
    memory with an asynchronous copy: a copy from pageable memory would
    make the host wait for the stream, a sync on every step."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def build_eval_step(model, packed=None):
    """``eval_step((images, labels))``: ``model``'s eval-mode forward on a
    batch on its device and the JAX step's sums for it, left on the
    device: ``{"loss": mean cross-entropy × rows, "correct": rows whose
    argmax is the label, "count": rows}``. With ``packed``, an exported
    collection (serve/packed_model.py ``export_packed_collection``), the
    step runs a copy of ``model`` whose quantized layers serve from their
    2-bit planes, as JAX passes its 'packed' collection to every apply;
    ``model`` itself is left as it was."""
    if packed:
        from atq_tpu_torch.serve.packed_model import attach_packed_collection

        model = copy.deepcopy(model)
        attach_packed_collection(model, packed)

    @torch.inference_mode()
    def eval_step(batch):
        images, labels = batch
        model.eval()
        logits = model(images)
        n = labels.shape[0]
        return {"loss": _cross_entropy(logits, labels) * n,
                "correct": (logits.argmax(-1) == labels).sum(),
                # A fill on the device: a host tensor copied there would
                # make the host wait for the stream on every batch.
                "count": torch.full((), n, dtype=torch.int32,
                                    device=labels.device)}

    return eval_step


def _run_eval(eval_step, loader, device):
    """``(accuracy %, mean loss)`` over a loader of normalized batches,
    each through ``eval_step`` (:func:`build_eval_step`); the sums stay on
    the device until one read at the end."""
    totals = {}
    for images, labels in loader:
        m = eval_step((_to_device(images, device),
                       _to_device(labels, device).long()))
        totals = {k: totals[k] + v if k in totals else v
                  for k, v in m.items()}
    if not totals:
        return 0.0, 0.0
    correct, loss, count = torch.stack([
        totals[k].double() for k in ("correct", "loss", "count")]).tolist()
    count = max(1.0, count)
    return 100.0 * correct / count, loss / count


class _StepClock:
    """Step-to-step times without a host sync per step: CUDA events on the
    card, the host clock on the CPU. Read once per epoch."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks,
                                                       self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _weight_distribution(weight, layer) -> str:
    """The ternary pattern's shares of ``layer``'s whole ``weight``."""
    w_t, _ = adaptive_ternary_quantization(
        weight.detach(), alpha=layer.alpha,
        sparsity_target=layer.sparsity_target)
    total = w_t.numel()
    pct = [100.0 * (w_t == v).sum().item() / total for v in (-1, 0, 1)]
    return (f"Weight distribution: -1: {pct[0]:.1f}% | 0: {pct[1]:.1f}% | "
            f"+1: {pct[2]:.1f}%")


def _whole_opt_state(opt, model_sh):
    state = opt.state_dict()
    if model_sh is None:
        return state
    return {k: model_sh.to_full(v) if isinstance(v, list) else v
            for k, v in state.items()}


def _local_opt_state(state, model_sh):
    if model_sh is None:
        return state
    return {k: model_sh.to_local(v) if isinstance(v, list) else v
            for k, v in state.items()}


def classifier_train_state(atq_model, base_model, atq_opt, base_opt,
                           step_gen, train_loader, epoch: int,
                           best_val_acc: float, sharded=None) -> dict:
    """Everything a resumed run needs to go on along the same trajectory
    (the live tensors): both models' parameters and buffers, both
    optimizers, the epochs done, the best validation accuracy, the step
    generator, the train loader's epoch and numpy's global RNG. With
    ``sharded`` (the two ``ShardedModel``s) every tensor is whole (a
    collective)."""
    atq_sh, base_sh = sharded if sharded is not None else (None, None)
    return {"epoch": epoch, "best_val_acc": float(best_val_acc),
            "atq_model": (atq_model.state_dict() if atq_sh is None
                          else atq_sh.full_state_dict()),
            "base_model": (base_model.state_dict() if base_sh is None
                           else base_sh.full_state_dict()),
            "atq_optimizer": _whole_opt_state(atq_opt, atq_sh),
            "base_optimizer": _whole_opt_state(base_opt, base_sh),
            "generator": step_gen.get_state(),
            "loader_epoch": getattr(train_loader, "epoch", None),
            "numpy_rng": numpy_rng_state()}


def load_classifier_train_state(state: dict, atq_model, base_model, atq_opt,
                                base_opt, step_gen, train_loader,
                                sharded=None) -> None:
    """Put :func:`classifier_train_state`'s values into the live objects,
    bit for bit (the epoch and best accuracy are the caller's); with
    ``sharded`` each whole tensor is re-sharded onto this rank."""
    atq_sh, base_sh = sharded if sharded is not None else (None, None)
    for model, model_sh, key in ((atq_model, atq_sh, "atq_model"),
                                 (base_model, base_sh, "base_model")):
        if model_sh is None:
            model.load_state_dict(state[key])
        else:
            model_sh.load_full_state_dict(state[key])
    atq_opt.load_state_dict(_local_opt_state(state["atq_optimizer"], atq_sh))
    base_opt.load_state_dict(_local_opt_state(state["base_optimizer"],
                                              base_sh))
    step_gen.set_state(state["generator"])
    if state["loader_epoch"] is not None:
        train_loader.epoch = state["loader_epoch"]
    set_numpy_rng_state(state["numpy_rng"])


def train_classifier(cfg: ClassifierConfig, loaders=None, verbose=True):
    """Full training run; returns ``(state, results)``. ``state`` holds the
    two models and their optimizers; with ``profile_dir``,
    ``results["profile_launches"]`` holds the kernel launches in the traced
    window."""
    from atq_tpu_torch.data.mnist import (
        get_fashion_mnist_data,
        get_mnist_data,
    )
    from atq_tpu_torch.utils.metrics import (
        count_parameters,
        measure_inference_time,
        measure_model_memory,
    )

    device = resolve_device(cfg.device)
    mesh = training_mesh(cfg.dp, cfg.tp, device)
    main_rank = world_rank() == 0
    verbose = verbose and main_rank
    if loaders is None:
        if cfg.dataset == "mnist":
            loaders = get_mnist_data(cfg.batch_size, cfg.data_dir,
                                     subset_fraction=1.0)
        elif cfg.dataset == "fashion_mnist":
            loaders = get_fashion_mnist_data(cfg.batch_size, cfg.data_dir,
                                             subset_fraction=1.0)
        else:
            raise ValueError(f"Unknown dataset: {cfg.dataset}")
    train_loader, val_loader, test_loader = loaders
    if cfg.device_augment and hasattr(train_loader, "raw"):
        train_loader.augment = False
        train_loader.raw = True

    hidden_size = 256 if cfg.wider_layers else 128
    init_gen = torch.Generator().manual_seed(cfg.seed)
    atq_model = ATQImageClassifier(
        num_classes=10, input_channels=1, use_rpb=cfg.use_rpb,
        sparsity_target=cfg.sparsity, hidden_size=hidden_size,
        grad_mode=cfg.grad_mode, device=device, generator=init_gen)
    base_model = BaselineCNNClassifier(hidden_size=hidden_size,
                                       device=device, generator=init_gen)

    steps_per_epoch = len(train_loader)
    decay_mask = ternary_latent_decay_mask(atq_model, cfg.grad_mode)
    atq_sh = ShardedModel(atq_model, mesh, fsdp=cfg.fsdp,
                          layer_names=TP_LAYERS)
    base_sh = ShardedModel(base_model, mesh, fsdp=cfg.fsdp,
                           layer_names=TP_LAYERS)
    atq_opt = make_optimizer(cfg, atq_sh.optim_params, steps_per_epoch,
                             weight_decay=1e-4, decay_mask=decay_mask)
    base_opt = make_optimizer(cfg, base_sh.optim_params, steps_per_epoch,
                              clip=False)
    multi = (atq_sh, base_sh) if mesh.size > 1 else None
    if multi is not None:
        atq_opt.global_norm_sq = atq_sh.global_norm_sq
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    train_step = build_train_step(atq_model, base_model, atq_opt, base_opt,
                                  cfg, step_gen, mesh, (atq_sh, base_sh))

    initial_sparsity, final_sparsity = 0.05, cfg.sparsity
    best_val_acc = 0.0
    results = {
        "train_accuracies": [], "val_accuracies": [],
        "sparsity_schedule": [], "imgs_per_sec": [], "epoch_seconds": [],
        "epoch_losses": [], "step_losses": [], "step_ms": [],
        "launches_per_step": [],
    }
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    ckpt_path = os.path.join(cfg.checkpoint_dir,
                             f"atq_model_{cfg.dataset}.npz")

    def train_state(epoch):
        return classifier_train_state(atq_model, base_model, atq_opt,
                                      base_opt, step_gen, train_loader,
                                      epoch, best_val_acc, multi)

    orbax_dir = os.path.join(cfg.checkpoint_dir, f"orbax_{cfg.dataset}")
    start_epoch = 0
    if cfg.resume:
        try:
            saved, start_epoch = restore_train_state(orbax_dir)
        except FileNotFoundError:
            if verbose:
                print("No checkpoint to resume from; starting fresh")
        else:
            load_classifier_train_state(saved, atq_model, base_model,
                                        atq_opt, base_opt, step_gen,
                                        train_loader, multi)
            best_val_acc = saved["best_val_acc"]
            if verbose or multi is not None:  # a collective with ranks
                digest = state_digest(to_host(train_state(start_epoch)))
            if verbose:
                print(f"Resumed from {orbax_dir} at epoch {start_epoch}")
                print(f"Restored training state (sha256 {digest})",
                      flush=True)

    # Rank 0 alone writes the trace and TensorBoard files.
    prof = (start_trace(cfg.profile_dir, device)
            if cfg.profile_dir and main_rank else None)
    traced_from = kernel_launches()
    tb = MetricsWriter(cfg.tensorboard_dir if main_rank else None)
    for epoch in range(start_epoch, cfg.epochs):
        current_sparsity = initial_sparsity + (
            final_sparsity - initial_sparsity
        ) * min(1.0, epoch / (cfg.epochs * 0.7))
        results["sparsity_schedule"].append(current_sparsity)
        l1_weight = cfg.l1_factor * min(1.0, epoch / (cfg.epochs * 0.5))
        if cfg.use_rpb:
            _set_all_sparsity(atq_model, current_sparsity)

        atq_model.train()
        base_model.train()
        sums, count, losses = None, 0, []
        launches0 = kernel_launches()
        clock = _StepClock(device)
        with record_function(TRAIN_SPAN):
            t0 = time.perf_counter()
            for images, labels in PrefetchLoader(train_loader):
                images = _to_device(images, device)
                labels = _to_device(labels, device).long()
                metrics = train_step(images, labels, l1_weight)
                clock.mark()
                losses.append(metrics["loss"])
                sums = (metrics if sums is None else
                        {k: sums[k] + v for k, v in metrics.items()})
                count += labels.shape[0]
            step_ms = clock.step_ms()
        epoch_time = time.perf_counter() - t0
        n_steps = len(losses)
        launches = kernel_launches()
        results["launches_per_step"].append(
            {k: (launches[k] - launches0[k]) / max(1, n_steps)
             for k in launches})
        step_losses = torch.stack(losses).cpu().tolist() if losses else []
        totals = {k: v.item() for k, v in (sums or {}).items()}
        imgs_per_sec = count / max(epoch_time, 1e-9)
        results["imgs_per_sec"].append(imgs_per_sec)
        results["epoch_seconds"].append(epoch_time)
        results["step_losses"].append(step_losses)
        results["step_ms"].append(step_ms)
        mean_loss = totals.get("loss", 0.0) / max(1, n_steps)
        results["epoch_losses"].append(mean_loss)

        train_acc = 100.0 * totals.get("atq_correct", 0) / max(1, count)
        base_acc = 100.0 * totals.get("base_correct", 0) / max(1, count)
        results["train_accuracies"].append(train_acc)
        with atq_sh.whole():
            val_acc = from_rank0(_run_eval(build_eval_step(atq_model),
                                          val_loader, device)[0])
        results["val_accuracies"].append(val_acc)
        tb.scalars(epoch + 1, {
            "train_acc": train_acc, "base_acc": base_acc,
            "val_acc": val_acc, "loss": mean_loss,
            "sparsity": current_sparsity, "imgs_per_sec": imgs_per_sec,
        }, prefix="classifier/")
        tb.flush()
        if verbose:
            print(f"Epoch {epoch + 1}/{cfg.epochs} | ATQ {train_acc:.1f}% | "
                  f"Base {base_acc:.1f}% | Loss {mean_loss:.3f} | "
                  f"Val {val_acc:.1f}% | Sparsity {current_sparsity:.2f} | "
                  f"{imgs_per_sec:.0f} imgs/s | {epoch_time:.1f}s",
                  flush=True)
        if cfg.use_rpb and (epoch + 1) % 5 == 0:
            weight = atq_sh.full_state_dict()["classifier_0.weight"]
            if verbose:
                print(_weight_distribution(weight, atq_model.classifier_0))
        if prof is not None and epoch == start_epoch:
            stop_trace(prof, device)
            prof = None
            now = kernel_launches()
            results["profile_launches"] = {k: now[k] - traced_from[k]
                                           for k in now}
        if val_acc > best_val_acc:
            best_val_acc = val_acc
            whole = atq_sh.full_state_dict()
            if main_rank:
                save_checkpoint(to_jax_variables(whole), ckpt_path)
            if verbose:
                print(f"Model saved with accuracy: {best_val_acc:.1f}%")
        if (epoch + 1) % cfg.orbax_freq == 0 or (epoch + 1) == cfg.epochs:
            # After this epoch's best-accuracy update (JAX writes before
            # it, so its resumed run forgets that epoch's accuracy).
            host = to_host(train_state(epoch + 1))
            if main_rank:
                state_path = save_train_state(orbax_dir, epoch + 1, host)
            if verbose:
                print(f"Saved training state to {state_path} (sha256 "
                      f"{state_digest(host)})", flush=True)

    if prof is not None:  # no epoch ran
        stop_trace(prof, device)
    with atq_sh.whole(), base_sh.whole():
        test_acc, _ = _run_eval(build_eval_step(atq_model), test_loader,
                                device)
        base_test_acc, _ = _run_eval(build_eval_step(base_model),
                                     test_loader, device)
    if multi is not None:
        # The efficiency figures below time one process's forward: whole
        # copies on every rank, whose forward is no collective.
        whole = atq_sh.full_state_dict()
        base_whole = base_sh.full_state_dict()
        atq_model = ATQImageClassifier(
            num_classes=10, input_channels=1, use_rpb=cfg.use_rpb,
            sparsity_target=cfg.sparsity, hidden_size=hidden_size,
            grad_mode=cfg.grad_mode, device=device)
        atq_model.load_state_dict(whole)
        base_model = BaselineCNNClassifier(hidden_size=hidden_size,
                                           device=device)
        base_model.load_state_dict(base_whole)
    ips = results["imgs_per_sec"]
    results.update({
        "test_acc": test_acc,
        "baseline_test_acc": base_test_acc,
        "best_val_acc": best_val_acc,
        "mean_imgs_per_sec": (float(np.mean(ips[1:]) if len(ips) > 1
                                    else ips[0]) if ips else None),
        "checkpoint": ckpt_path if best_val_acc > 0 else None,
    })
    if verbose:
        print(f"ATQ Test Accuracy: {test_acc:.1f}%")
        print(f"Baseline Test Accuracy: {base_test_acc:.1f}%")

    # Efficiency comparison (reference train.py:356-370).
    one = torch.ones((1, 28, 28, 1), device=device)
    atq_time = measure_inference_time(atq_model, one)
    base_time = measure_inference_time(base_model, one)
    atq_n, base_n = count_parameters(atq_model), count_parameters(base_model)
    atq_mem = measure_model_memory(atq_model)
    base_mem = measure_model_memory(base_model)
    results.update({
        "atq_inference_ms": atq_time, "baseline_inference_ms": base_time,
        "atq_params": atq_n, "baseline_params": base_n,
        "atq_memory_mb": atq_mem, "baseline_memory_mb": base_mem,
    })
    if verbose:
        print("\nEfficiency Comparison:")
        print(f"ATQ Model: {atq_n:,} params | {atq_mem:.2f} MB | "
              f"{atq_time:.2f} ms | {test_acc:.1f}%")
        print(f"Baseline: {base_n:,} params | {base_mem:.2f} MB | "
              f"{base_time:.2f} ms | {base_test_acc:.1f}%")
        print(f"Ratios: Params {base_n / max(1, atq_n):.2f}x"
              f" | Memory {base_mem / max(1e-9, atq_mem):.2f}x | "
              f"Speed {base_time / max(1e-9, atq_time):.2f}x | "
              f"Acc Delta {test_acc - base_test_acc:.1f}%")
    tb.close()
    state = {"atq_model": atq_model, "base_model": base_model,
             "atq_opt": atq_opt, "base_opt": base_opt,
             "generator": step_gen, "mesh": mesh,
             "sharded": (atq_sh, base_sh)}
    return state, results


def _restore(node, path, data):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _restore(v, path + (str(k),), data)
                for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # named tuple
        return type(node)(*(_restore(getattr(node, f), path + (f,), data)
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_restore(v, path + (str(i),), data)
                          for i, v in enumerate(node))
    name = "/".join(path)
    if name not in data:
        return node
    t = torch.from_numpy(data[name])
    return t.to(node.device) if isinstance(node, torch.Tensor) else t


def load_checkpoint(path: str, template=None):
    """A ``.npz`` checkpoint of the JAX layout (keys are '/'-joined paths),
    as the JAX trainer's reader gives it, with tensors for arrays.

    Without ``template``: the nested dict by path segments
    (utils/jax_interop.py ``load_checkpoint``), enough for params, quant
    and batch_stats. With one (nested dicts, lists, tuples and named
    tuples, e.g. an optimizer's state): the same structure, each leaf
    replaced by the file's array at its key path (a dict key, a sequence
    index, a named tuple's field name), on the leaf's device when the leaf
    is a tensor; a leaf whose path the file lacks is kept, and ``None``
    stays ``None``."""
    if template is None:
        def to_tensors(node):
            if isinstance(node, dict):
                return {k: to_tensors(v) for k, v in node.items()}
            return torch.from_numpy(node)

        return to_tensors(jax_load_checkpoint(path))
    with np.load(path) as f:
        data = {k: np.asarray(f[k]) for k in f.files}
    return _restore(template, (), data)
