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

Not ported yet (each raises ``NotImplementedError``): TensorBoard,
``profile_dir`` traces, and data, tensor or fully-sharded parallelism
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from atq_tpu_torch.core.quantize import adaptive_ternary_quantization
from atq_tpu_torch.data.augment import classifier_augment
from atq_tpu_torch.data.mnist import FASHION_STATS, MNIST_STATS
from atq_tpu_torch.data.prefetch import PrefetchLoader
from atq_tpu_torch.models.image_classifier import (
    ATQImageClassifier,
    BaselineCNNClassifier,
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
from atq_tpu_torch.train.schedules_lr import (
    step_lr_schedule,
    warmup_cosine_schedule,
)
from atq_tpu_torch.utils.jax_interop import save_checkpoint, to_jax_variables
from atq_tpu_torch.utils.platform import resolve_device


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


def _check_supported(cfg: ClassifierConfig) -> None:
    later = [
        (cfg.tensorboard_dir is not None, "tensorboard_dir"),
        (cfg.profile_dir is not None, "profile_dir"),
        (cfg.dp not in (None, 1) or cfg.tp != 1 or cfg.fsdp,
         "dp/tp/fsdp parallelism (slice H)"),
    ]
    for unsupported, what in later:
        if unsupported:
            raise NotImplementedError(
                f"{what} is not ported to atq_tpu_torch yet "
                f"(ROADMAP.md queue 1)")


def _l1_penalty(model: torch.nn.Module) -> torch.Tensor:
    """Σ|p| over every parameter named ``weight``: the quantized layers'
    latent weights, the conv kernels and the BatchNorm scales (the JAX
    leaves ``weight``, ``kernel`` and ``scale``)."""
    return sum(p.abs().sum() for name, p in model.named_parameters()
               if name.rsplit(".", 1)[-1] == "weight")


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
      (``clip_grad_norm_`` differs: it adds 1e-6 to the norm);
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
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
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
                     generator: Optional[torch.Generator] = None):
    """``train_step(images, labels, l1_weight) -> metrics``: one co-trained
    step (teacher update first, then the student distilled from the
    teacher's pre-update logits). ``generator`` drives augmentation and
    dropout. After the call each parameter's ``.grad`` holds this step's
    gradient; the metrics are device tensors. With ``cfg.grad_accum_steps``
    N > 1 the step is ``accum_train_step`` (the module docstring); a batch
    that N does not divide raises ``ValueError``, as in JAX."""

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
        images = prepare(images)
        base_model.zero_grad(set_to_none=True)
        base_logits = base_model(images, generator=generator)
        base_loss = _cross_entropy(base_logits, labels)
        base_loss.backward()
        base_opt.step()

        atq_model.zero_grad(set_to_none=True)
        loss, logits = student_loss(images, labels, base_logits, l1_weight)
        loss.backward()
        atq_opt.step()
        return {
            "loss": loss.detach(),
            "base_loss": base_loss.detach(),
            "atq_correct": (logits.argmax(-1) == labels).sum(),
            "base_correct": (base_logits.argmax(-1) == labels).sum(),
        }

    n_accum = cfg.grad_accum_steps

    def accum_train_step(images, labels, l1_weight):
        total = images.shape[0]
        if total % n_accum:
            raise ValueError(f"batch size {total} not divisible by "
                             f"grad_accum_steps {n_accum}")
        micro = total // n_accum
        base_model.zero_grad(set_to_none=True)
        atq_model.zero_grad(set_to_none=True)
        sums = None
        for i in range(n_accum):
            part = slice(i * micro, (i + 1) * micro)
            x, y = prepare(images[part]), labels[part]
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
        base_opt.step()
        atq_opt.step()
        return sums

    return train_step if n_accum <= 1 else accum_train_step


def _to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host batch on ``device``. On the card it goes through pinned
    memory with an asynchronous copy: a copy from pageable memory would
    make the host wait for the stream, a sync on every step."""
    t = torch.from_numpy(array)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@torch.inference_mode()
def _run_eval(model, loader, device):
    """``(accuracy %, mean loss)`` over a loader of normalized batches; the
    sums stay on the device until the end."""
    model.eval()
    loss = torch.zeros((), device=device)
    correct = torch.zeros((), dtype=torch.long, device=device)
    count = 0
    for images, labels in loader:
        x = _to_device(images, device)
        y = _to_device(labels, device).long()
        logits = model(x)
        loss += _cross_entropy(logits, y) * y.shape[0]
        correct += (logits.argmax(-1) == y).sum()
        count += y.shape[0]
    return (100.0 * correct.item() / max(1, count),
            loss.item() / max(1, count))


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


def _weight_distribution(atq_model) -> str:
    layer = atq_model.classifier_0
    w_t, _ = adaptive_ternary_quantization(
        layer.weight.detach(), alpha=layer.alpha,
        sparsity_target=layer.sparsity_target)
    total = w_t.numel()
    pct = [100.0 * (w_t == v).sum().item() / total for v in (-1, 0, 1)]
    return (f"Weight distribution: -1: {pct[0]:.1f}% | 0: {pct[1]:.1f}% | "
            f"+1: {pct[2]:.1f}%")


def classifier_train_state(atq_model, base_model, atq_opt, base_opt,
                           step_gen, train_loader, epoch: int,
                           best_val_acc: float) -> dict:
    """Everything a resumed run needs to go on along the same trajectory
    (the live tensors): both models' parameters and buffers, both
    optimizers, the epochs done, the best validation accuracy, the step
    generator, the train loader's epoch and numpy's global RNG."""
    return {"epoch": epoch, "best_val_acc": float(best_val_acc),
            "atq_model": atq_model.state_dict(),
            "base_model": base_model.state_dict(),
            "atq_optimizer": atq_opt.state_dict(),
            "base_optimizer": base_opt.state_dict(),
            "generator": step_gen.get_state(),
            "loader_epoch": getattr(train_loader, "epoch", None),
            "numpy_rng": numpy_rng_state()}


def load_classifier_train_state(state: dict, atq_model, base_model, atq_opt,
                                base_opt, step_gen, train_loader) -> None:
    """Put :func:`classifier_train_state`'s values into the live objects,
    bit for bit (the epoch and best accuracy are the caller's)."""
    atq_model.load_state_dict(state["atq_model"])
    base_model.load_state_dict(state["base_model"])
    atq_opt.load_state_dict(state["atq_optimizer"])
    base_opt.load_state_dict(state["base_optimizer"])
    step_gen.set_state(state["generator"])
    if state["loader_epoch"] is not None:
        train_loader.epoch = state["loader_epoch"]
    set_numpy_rng_state(state["numpy_rng"])


def train_classifier(cfg: ClassifierConfig, loaders=None, verbose=True,
                     epoch_context=None):
    """Full training run; returns ``(state, results)``. ``state`` holds the
    two models and their optimizers. ``epoch_context(epoch)``, if given,
    returns a context manager wrapped around that epoch's training steps
    (the chip smoke run traces one epoch with it)."""
    from atq_tpu_torch.data.mnist import (
        get_fashion_mnist_data,
        get_mnist_data,
    )
    from atq_tpu_torch.utils.metrics import (
        count_parameters,
        measure_inference_time,
        measure_model_memory,
    )

    _check_supported(cfg)
    device = resolve_device(cfg.device)
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
    atq_opt = make_optimizer(
        cfg, atq_model.named_parameters(), steps_per_epoch,
        weight_decay=1e-4,
        decay_mask=ternary_latent_decay_mask(atq_model, cfg.grad_mode))
    base_opt = make_optimizer(cfg, base_model.named_parameters(),
                              steps_per_epoch, clip=False)
    step_gen = torch.Generator(device=device).manual_seed(cfg.seed + 17)
    train_step = build_train_step(atq_model, base_model, atq_opt, base_opt,
                                  cfg, step_gen)

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
                                      epoch, best_val_acc)

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
                                        train_loader)
            best_val_acc = saved["best_val_acc"]
            if verbose:
                print(f"Resumed from {orbax_dir} at epoch {start_epoch}")
                print(f"Restored training state (sha256 "
                      f"{state_digest(to_host(train_state(start_epoch)))})",
                      flush=True)

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
        ctx = (epoch_context(epoch) if epoch_context is not None
               else contextlib.nullcontext())
        sums, count, losses = None, 0, []
        launches0 = kernel_launches()
        clock = _StepClock(device)
        t0 = time.perf_counter()
        with ctx:
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
        val_acc, _ = _run_eval(atq_model, val_loader, device)
        results["val_accuracies"].append(val_acc)
        if verbose:
            print(f"Epoch {epoch + 1}/{cfg.epochs} | ATQ {train_acc:.1f}% | "
                  f"Base {base_acc:.1f}% | Loss {mean_loss:.3f} | "
                  f"Val {val_acc:.1f}% | Sparsity {current_sparsity:.2f} | "
                  f"{imgs_per_sec:.0f} imgs/s | {epoch_time:.1f}s",
                  flush=True)
        if cfg.use_rpb and (epoch + 1) % 5 == 0 and verbose:
            print(_weight_distribution(atq_model))
        if val_acc > best_val_acc:
            best_val_acc = val_acc
            save_checkpoint(to_jax_variables(atq_model.state_dict()),
                            ckpt_path)
            if verbose:
                print(f"Model saved with accuracy: {best_val_acc:.1f}%")
        if (epoch + 1) % cfg.orbax_freq == 0 or (epoch + 1) == cfg.epochs:
            # After this epoch's best-accuracy update (JAX writes before
            # it, so its resumed run forgets that epoch's accuracy).
            host = to_host(train_state(epoch + 1))
            state_path = save_train_state(orbax_dir, epoch + 1, host)
            if verbose:
                print(f"Saved training state to {state_path} (sha256 "
                      f"{state_digest(host)})", flush=True)

    test_acc, _ = _run_eval(atq_model, test_loader, device)
    base_test_acc, _ = _run_eval(base_model, test_loader, device)
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
    state = {"atq_model": atq_model, "base_model": base_model,
             "atq_opt": atq_opt, "base_opt": base_opt,
             "generator": step_gen}
    return state, results
