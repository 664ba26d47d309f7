"""Training: loss, optimizer, LR schedule and the train step on one GPU.

Counterpart of ``olmoasr_tpu/training/train.py``, with the reference recipe:
AdamW beta=(0.9, 0.98), eps=1e-6, weight decay 0.1 on every parameter, peak
LR per variant, linear warmup over 0.2% of steps then linear decay, max grad
norm 1.0; fp32 parameters and optimizer state, compute in ``compute_dtype``,
remat per block, gradient accumulation over the batch's leading axis.

The update is optax's ``chain(clip_by_global_norm, adamw)`` as the JAX
package builds it: the clip scales by ``max_norm / norm`` only when
``norm >= max_norm``, and optax counts its own updates from 0, so update n
(1-based) uses ``lr_schedule(n - 1)``: the first update has learning rate 0
and leaves the parameters as they were, while the moments move.
``torch.optim.AdamW`` over one parameter group computes the same update
(``p - lr * (adam + wd * p)``) when its learning rate is set so before each
step. With ``mu_dtype`` or ``nu_dtype`` set, :class:`CastMomentAdamW` takes
its place: the JAX package's ``_scale_by_adam_cast`` chain (both set) or
``optax.adamw(mu_dtype=...)`` (``mu_dtype`` alone). ``attention`` picks the
attention kernels, ``"kernel"`` or ``"flash"``
(``models.whisper.forward_train``): the JAX package picks them with its
``OLMOASR_ENC_ATTN`` / ``OLMOASR_DEC_ATTN`` / ``OLMOASR_TRAIN_FLASH_DEC``
switches. Not ported, because they tune the TPU: ``encoder_flash`` /
``resolved_flash`` (the XLA-attention fallback), ``OLMOASR_GRADS_BF16``,
``OLMOASR_CE_CHUNK``.

Multi-rank training (``shard_train_state`` and ``make_train_step`` with a
mesh; the JAX package's ``shard_train_state`` and
``make_sharded_train_step``) runs on a (data, fsdp) mesh of
``parallel.mesh``: DDP over every rank when the fsdp axis is 1, else FSDP2
(``fully_shard`` on each block, then on the root) on the fsdp axis, hybrid
(HSDP) when both axes exceed 1; ``zero2`` keeps the parameters unsharded
between the forward and the backward (SHARD_GRAD_OP). Parameters, their
all-gathers and the gradient reductions stay fp32. The numbers are the JAX
sharded step's: each micro-batch's loss averages over the valid tokens of
the global micro-batch (every rank's), the gradients are summed over the
ranks and synchronised once a step, after the last micro-batch, and the
clip's norm is over the whole gradient.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from olmoasr_tpu_torch import audio as audio_mod
from olmoasr_tpu_torch.models import whisper as model_mod
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
from olmoasr_tpu_torch.parallel.mesh import DATA_AXIS, FSDP_AXIS
from olmoasr_tpu_torch.tracing import span

@dataclass(frozen=True)
class TrainConfig:
    train_steps: int = 524_288
    eff_batch_size: int = 512
    micro_batch_size: int = 8
    peak_lr: float = 1.5e-3
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    warmup_frac: float = 0.002  # warmup = 0.2% of steps (train_timestamps.py:770)
    remat: bool = True
    compute_dtype: Any = torch.bfloat16
    # Adam's moment storage dtypes (CastMomentAdamW); None = the parameters'
    # fp32, the reference's exact recipe. A bf16 mu and nu halve the
    # optimizer state; the moment arithmetic stays fp32, cast on store.
    mu_dtype: Any = None
    nu_dtype: Any = None
    attention: str = "kernel"  # "kernel" (ops.train_attention) or "flash" (ops.flash)

    @property
    def warmup_steps(self) -> int:
        return max(int(self.train_steps * self.warmup_frac), 1)


@dataclass
class TrainState:
    """The model (fp32 parameters), its optimizer and the count of completed
    steps. ``train_step`` updates it in place. After ``shard_train_state``
    the model is the Whisper sharded in place by FSDP2, or its DDP wrapper
    (:func:`unwrap` gives the Whisper)."""

    model: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def lr_schedule(config: TrainConfig):
    """Linear warmup to peak over 0.2% of steps, then linear decay to 0
    (train_timestamps.py:738-783), in fp32 as the JAX package computes it."""
    f32 = np.float32
    warmup, total = f32(config.warmup_steps), f32(config.train_steps)
    span = f32(max(config.train_steps - config.warmup_steps, 1))

    def fn(step) -> float:
        s = f32(step)
        factor = s / warmup if s < warmup else max((total - s) / span, f32(0.0))
        return float(f32(config.peak_lr) * f32(factor))

    return fn


class CastMomentAdamW(torch.optim.Optimizer):
    """Adam with its moments stored in ``mu_dtype`` / ``nu_dtype`` (None: the
    parameter's dtype), then the decayed weights, then the learning rate:
    ``p -= lr * (adam + weight_decay * p)``, the arithmetic in fp32.

    Where ``nu_dtype`` is set (``cast_update``, the JAX package's
    ``_scale_by_adam_cast``) the update reads the moments as stored,
    ``(mu/bc1) / (sqrt(nu/bc2) + eps)``. With ``mu_dtype`` alone
    (``optax.adamw(mu_dtype=...)``) it reads the fp32 moments before their cast
    to storage, and mu's decay term ``b1 * mu`` is computed in ``mu_dtype``,
    ``b1`` rounded to it, as jax computes a Python scalar times an array.
    Clipping is the train step's (:func:`clip_by_global_norm`). The learning
    rate is the group's ``lr``, which the train step sets before each
    step."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.98), eps: float = 1e-6,
                 weight_decay: float = 0.1, mu_dtype=None, nu_dtype=None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype
        self.cast_update = nu_dtype is not None

    def load_state_dict(self, state_dict):
        """``torch.optim.Optimizer`` casts loaded moments to the parameters'
        dtype; put them back in their storage dtypes."""
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            for key, dtype in (("exp_avg", self.mu_dtype), ("exp_avg_sq", self.nu_dtype)):
                if key in st:
                    st[key] = st[key].to(dtype or p.dtype)

    @torch.no_grad()
    def step(self, closure=None):
        f32 = torch.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.nu_dtype or p.dtype)
                st["step"] += 1
                # elementwise: on a sharded (DTensor) parameter, its shard
                g = _local(p.grad).to(f32)
                mu, nu = _local(st["exp_avg"]), _local(st["exp_avg_sq"])
                if self.cast_update:
                    mu_new = b1 * mu.to(f32) + (1 - b1) * g
                else:  # optax: (1 - b1) * g + b1 * mu, b1 * mu in mu's dtype
                    mu_new = (1 - b1) * g + (mu * torch.tensor(b1, dtype=mu.dtype)).to(f32)
                nu_new = b2 * nu.to(f32) + (1 - b2) * g.square()
                mu.copy_(mu_new)
                nu.copy_(nu_new)
                if self.cast_update:
                    mu_new, nu_new = mu.to(f32), nu.to(f32)
                c = np.float32(st["step"])
                bc1 = float(np.float32(1) - np.float32(b1) ** c)
                bc2 = float(np.float32(1) - np.float32(b2) ** c)
                update = (mu_new / bc1) / ((nu_new / bc2).sqrt() + group["eps"])
                p = _local(p)
                update = update + group["weight_decay"] * p.to(f32)
                p.add_((-group["lr"] * update).to(p.dtype))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view: writes go through); any other
    tensor itself."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def make_optimizer(config: TrainConfig, params) -> torch.optim.Optimizer:
    """The reference's AdamW (``torch.optim.AdamW``), or
    :class:`CastMomentAdamW` where ``mu_dtype`` or ``nu_dtype`` is set, as
    the JAX ``make_optimizer`` branches (train.py:103-160)."""
    kw = dict(lr=0.0, betas=(config.beta1, config.beta2), eps=config.eps,
              weight_decay=config.weight_decay)
    if config.mu_dtype is not None or config.nu_dtype is not None:
        return CastMomentAdamW(list(params), mu_dtype=config.mu_dtype,
                               nu_dtype=config.nu_dtype, **kw)
    return torch.optim.AdamW(list(params), **kw)


def unwrap(model):
    """The Whisper of a training model: a DDP wrapper's module, else the
    model itself (FSDP2 shards it in place)."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def loss_fn(model, mel: torch.Tensor, text_input: torch.Tensor, text_target: torch.Tensor,
            padding_mask: Optional[torch.Tensor], *, compute_dtype=torch.bfloat16,
            remat: bool = True, attention: str = "kernel", return_pred: bool = False,
            n_tokens: Optional[torch.Tensor] = None):
    """Teacher-forced cross entropy that ignores PADDING_TOKEN
    (train_timestamps.py:1444-1450), as logsumexp minus the target's logit;
    returns (loss, aux) with the teacher-forced ``accuracy`` and
    ``n_tokens``, and with ``return_pred`` the (B, T) argmax ids ``pred``
    (validation reads these instead of the logits). The sums are divided by
    ``n_tokens`` where given (a rank's share of the global micro-batch's
    loss: the global count of valid tokens), else by this batch's count.
    The forward is the model's call (``Whisper.forward``, or a DDP
    wrapper's).

    A (B, 480000) ``mel`` is the ``device_mel`` transport's raw 30 s PCM
    (int16, or f32): its log-mel is computed here on the batch's device, in
    fp32 with autocast off, without gradients and outside the remat
    checkpoints, once per micro-batch (JAX ``loss_fn``; about 0.02% of the
    step's FLOPs, which ``train_flops_per_sample`` leaves out)."""
    if mel.dim() == 2:
        with torch.no_grad(), torch.autocast(mel.device.type, enabled=False):
            mel = audio_mod.log_mel_spectrogram(mel, unwrap(model).dims.n_mels)
    logits = model(mel, text_input, padding_mask, compute_dtype=compute_dtype, remat=remat,
                   attention=attention)
    target = text_target.to(logits.device).long()
    valid = target != PADDING_TOKEN
    n_valid = (valid.sum() if n_tokens is None else n_tokens).clamp_min(1)
    safe = torch.where(valid, target, 0)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, nll, 0.0).sum() / n_valid
    pred = logits.argmax(dim=-1)
    aux = {"accuracy": ((pred == target) & valid).sum() / n_valid, "n_tokens": n_valid}
    if return_pred:
        aux["pred"] = pred
    return loss, aux


def global_norm(tensors, group=None) -> torch.Tensor:
    """The L2 norm of all of ``tensors``. Sharded (DTensor) gradients add
    their shards' squares, summed over ``group``, the ranks that the shards
    of one tensor are spread over."""
    sq = torch.stack([_local(t).float().square().sum() for t in tensors]).sum()
    if group is not None:
        dist.all_reduce(sq, group=group)
    return sq.sqrt()


def clip_by_global_norm(grads, max_norm: float, group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: ``g / norm * max_norm`` when
    ``norm >= max_norm``. Returns the norm before clipping (over ``group``
    for sharded gradients, see :func:`global_norm`)."""
    norm = global_norm(grads, group)
    clipped = norm >= max_norm
    div = torch.where(clipped, norm, 1.0)
    mul = torch.where(clipped, max_norm, 1.0)
    for g in grads:
        _local(g).div_(div).mul_(mul)
    return norm


def _grad_sync(model, sync: bool):
    """Whether this backward synchronises the gradients across the ranks:
    DDP's ``no_sync`` or FSDP2's ``set_requires_gradient_sync`` for the
    micro-batches before the last."""
    if isinstance(model, DistributedDataParallel):
        return nullcontext() if sync else model.no_sync()
    set_sync = getattr(model, "set_requires_gradient_sync", None)  # an FSDP2 module
    if set_sync is not None:
        set_sync(sync)
    return nullcontext()


def make_train_step(dims: ModelDimensions, config: TrainConfig, mesh=None):
    """The train step: ``step(state, batch) -> (state, metrics)``. The batch
    is (accum, micro_B, ...); the gradient is the mean of the micro-batches'
    gradients, each of a loss averaged over that micro-batch's valid tokens.
    Metrics (tensors on the device, not synchronised): ``loss`` and
    ``accuracy`` averaged over the micro-batches, ``grad_norm`` before
    clipping and ``lr = lr_schedule(step)``.

    With the ``mesh`` of :func:`shard_train_state` (the JAX package's
    ``make_sharded_train_step``), the batch is this rank's share of the
    global batch, every micro-batch's loss is averaged over the valid tokens
    of all ranks' shares (one all-reduce of the counts a step), the
    gradients are summed over the ranks (DDP and FSDP2 average them: times
    the world size), synchronised once, after the last micro-batch, and the
    metrics are those of the global batch on every rank."""
    schedule = lr_schedule(config)
    world = 1 if mesh is None else mesh.size()
    norm_group = None
    if mesh is not None and mesh[FSDP_AXIS].size() > 1:
        norm_group = mesh[FSDP_AXIS].get_group()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        params = [p for p in model.parameters() if p.requires_grad]
        opt.zero_grad(set_to_none=True)
        n_accum = batch["mel"].shape[0]
        counts = None
        if world > 1:
            counts = (batch["text_target"] != PADDING_TOKEN).flatten(1).sum(1)
            dist.all_reduce(counts)
        loss_sum = acc_sum = 0.0
        for i in range(n_accum):
            with span("train.micro"), _grad_sync(model, i == n_accum - 1):
                loss, aux = loss_fn(
                    model, batch["mel"][i], batch["text_input"][i], batch["text_target"][i],
                    None if batch.get("padding_mask") is None else batch["padding_mask"][i],
                    compute_dtype=config.compute_dtype, remat=config.remat,
                    attention=config.attention, n_tokens=None if counts is None else counts[i],
                )
                loss.backward()  # sums into the fp32 .grad of each parameter
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + aux["accuracy"]
        with span("train.update"):
            grads = [p.grad for p in params]
            if world > 1:
                sums = torch.stack([loss_sum, acc_sum])
                dist.all_reduce(sums)
                loss_sum, acc_sum = sums[0], sums[1]
                for g in grads:
                    g.mul_(world)
            if n_accum > 1:
                for g in grads:
                    g.div_(n_accum)
            norm = clip_by_global_norm(grads, config.max_grad_norm, norm_group)
            lr = schedule(state.step)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
        metrics = {"loss": loss_sum / n_accum, "accuracy": acc_sum / n_accum,
                   "grad_norm": norm, "lr": lr}
        state.step += 1
        return state, metrics

    return train_step


def shard_train_state(state: TrainState, mesh, config: TrainConfig, *,
                      zero2: bool = False) -> TrainState:
    """``state`` (a fresh one: its optimizer has taken no step) spread over
    the ranks of the (data, fsdp) ``mesh``, the JAX package's
    ``shard_train_state``: with an fsdp axis of 1, the model wrapped in DDP
    over every rank; else ``fully_shard`` on each block, then on the root,
    over the fsdp axis, or over both axes (HSDP: replicated over data,
    sharded over fsdp) when the data axis exceeds 1. ``zero2`` keeps the
    parameters unsharded from the forward to the backward (SHARD_GRAD_OP,
    FSDP2's ``reshard_after_forward=False``): gradients and optimizer state
    stay sharded. FSDP2 replaces the parameters with sharded ones, so the
    optimizer is built anew over them."""
    if state.optimizer.state:
        raise ValueError("shard_train_state takes a state whose optimizer has taken no step")
    model = state.model
    if mesh[FSDP_AXIS].size() == 1:
        device = next(model.parameters()).device
        model = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False)  # the one buffer is the constant sinusoid table
    else:
        from torch.distributed.fsdp import fully_shard

        shard_mesh = mesh[FSDP_AXIS] if mesh[DATA_AXIS].size() == 1 else mesh
        for blk in (*model.encoder.blocks, *model.decoder.blocks):
            fully_shard(blk, mesh=shard_mesh, reshard_after_forward=not zero2)
        fully_shard(model, mesh=shard_mesh, reshard_after_forward=not zero2)
    return TrainState(model, make_optimizer(config, model.parameters()), state.step)


def train_flops_per_sample(dims: ModelDimensions) -> float:
    """Analytic forward + backward FLOPs of one training sample (30 s of
    audio and n_text_ctx text positions), matrix products only (softmax and
    LN left out, under 2%), the backward counted as twice the forward; the
    remat recompute is not counted. A copy of ``bench.py``'s
    ``train_flops_per_sample``."""
    d, L_a = dims.n_audio_state, dims.n_audio_layer
    dt, L_t = dims.n_text_state, dims.n_text_layer
    Ta, Tt = dims.n_audio_ctx, dims.n_text_ctx  # 1500, 448
    conv = 2 * 3 * dims.n_mels * d * (2 * Ta) + 2 * 3 * d * d * Ta
    enc_layer = 8 * Ta * d * d + 4 * Ta * Ta * d + 16 * Ta * d * d
    dec_layer = (
        8 * Tt * dt * dt + 4 * Tt * Tt * dt  # self attn
        + 4 * Tt * dt * dt + 4 * Ta * dt * dt + 4 * Tt * Ta * dt  # cross
        + 16 * Tt * dt * dt  # mlp
    )
    logits = 2 * Tt * dt * (dims.n_vocab + 1)
    fwd = conv + L_a * enc_layer + L_t * dec_layer + logits
    return 3.0 * fwd


def init_train_state(seed: int, dims: ModelDimensions, config: TrainConfig,
                     device="cuda") -> TrainState:
    """fp32 parameters with the padding row, drawn from a ``torch.Generator``
    seeded with ``seed`` (the port's ``init_params``), on ``device``."""
    model = model_mod.empty_model(dims, include_padding_token=True, device=device,
                                  dtype=torch.float32)
    model_mod.init_params(model, torch.Generator().manual_seed(seed), include_padding_token=True)
    model.train()
    return TrainState(model, make_optimizer(config, model.parameters()), 0)
