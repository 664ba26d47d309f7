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
step. ``attention`` picks the attention kernels, ``"kernel"`` or ``"flash"``
(``models.whisper.forward_train``): the JAX package picks them with its
``OLMOASR_ENC_ATTN`` / ``OLMOASR_DEC_ATTN`` / ``OLMOASR_TRAIN_FLASH_DEC``
switches. Not ported, because they tune the TPU: ``encoder_flash`` /
``resolved_flash`` (the XLA-attention fallback), ``OLMOASR_GRADS_BF16``,
``OLMOASR_CE_CHUNK``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from olmoasr_tpu_torch import audio as audio_mod
from olmoasr_tpu_torch.models import whisper as model_mod
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN

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
    # moment storage dtypes; None = the parameters' fp32 (the JAX package's
    # _scale_by_adam_cast for other dtypes is not ported yet)
    mu_dtype: Any = None
    nu_dtype: Any = None
    attention: str = "kernel"  # "kernel" (ops.train_attention) or "flash" (ops.flash)

    @property
    def warmup_steps(self) -> int:
        return max(int(self.train_steps * self.warmup_frac), 1)


@dataclass
class TrainState:
    """The model (fp32 parameters), its optimizer and the count of completed
    steps. ``train_step`` updates it in place."""

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


def make_optimizer(config: TrainConfig, params) -> torch.optim.AdamW:
    if config.mu_dtype is not None or config.nu_dtype is not None:
        raise NotImplementedError("mu_dtype / nu_dtype: the cast-moment Adam is not ported")
    return torch.optim.AdamW(
        list(params), lr=0.0, betas=(config.beta1, config.beta2), eps=config.eps,
        weight_decay=config.weight_decay,
    )


def loss_fn(model, mel: torch.Tensor, text_input: torch.Tensor, text_target: torch.Tensor,
            padding_mask: Optional[torch.Tensor], *, compute_dtype=torch.bfloat16,
            remat: bool = True, attention: str = "kernel"):
    """Teacher-forced cross entropy that ignores PADDING_TOKEN
    (train_timestamps.py:1444-1450), as logsumexp minus the target's logit;
    returns (loss, aux) with the teacher-forced ``accuracy`` and
    ``n_tokens``.

    A (B, 480000) ``mel`` is the ``device_mel`` transport's raw 30 s PCM
    (int16, or f32): its log-mel is computed here on the batch's device, in
    fp32 with autocast off, without gradients and outside the remat
    checkpoints, once per micro-batch (JAX ``loss_fn``; about 0.02% of the
    step's FLOPs, which ``train_flops_per_sample`` leaves out)."""
    if mel.dim() == 2:
        with torch.no_grad(), torch.autocast(mel.device.type, enabled=False):
            mel = audio_mod.log_mel_spectrogram(mel, model.dims.n_mels)
    logits = model_mod.forward_train(model, mel, text_input, padding_mask,
                                     compute_dtype=compute_dtype, remat=remat,
                                     attention=attention)
    target = text_target.to(logits.device).long()
    valid = target != PADDING_TOKEN
    n_valid = valid.sum().clamp_min(1)
    safe = torch.where(valid, target, 0)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, nll, 0.0).sum() / n_valid
    pred = logits.argmax(dim=-1)
    aux = {"accuracy": ((pred == target) & valid).sum() / n_valid, "n_tokens": n_valid}
    return loss, aux


def global_norm(tensors) -> torch.Tensor:
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def make_train_step(dims: ModelDimensions, config: TrainConfig):
    """The train step: ``step(state, batch) -> (state, metrics)``. The batch
    is (accum, micro_B, ...); the gradient is the mean of the micro-batches'
    gradients, each of a loss averaged over that micro-batch's own valid
    tokens. Metrics (tensors on the device, not synchronised): ``loss`` and
    ``accuracy`` averaged over the micro-batches, ``grad_norm`` before
    clipping and ``lr = lr_schedule(step)``."""
    schedule = lr_schedule(config)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model, opt = state.model, state.optimizer
        params = [p for p in model.parameters() if p.requires_grad]
        opt.zero_grad(set_to_none=True)
        n_accum = batch["mel"].shape[0]
        loss_sum = acc_sum = 0.0
        for i in range(n_accum):
            loss, aux = loss_fn(
                model, batch["mel"][i], batch["text_input"][i], batch["text_target"][i],
                None if batch.get("padding_mask") is None else batch["padding_mask"][i],
                compute_dtype=config.compute_dtype, remat=config.remat,
                attention=config.attention,
            )
            loss.backward()  # sums into the fp32 .grad of each parameter
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + aux["accuracy"]
        grads = [p.grad for p in params]
        if n_accum > 1:
            for g in grads:
                g.div_(n_accum)
        norm = global_norm(grads)
        # optax.clip_by_global_norm: g / norm * max_norm when norm >= max_norm
        clipped = norm >= config.max_grad_norm
        div = torch.where(clipped, norm, 1.0)
        mul = torch.where(clipped, config.max_grad_norm, 1.0)
        for g in grads:
            g.div_(div).mul_(mul)
        lr = schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        metrics = {"loss": loss_sum / n_accum, "accuracy": acc_sum / n_accum,
                   "grad_norm": norm, "lr": lr}
        state.step += 1
        return state, metrics

    return train_step


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
