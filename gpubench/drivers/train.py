"""Training: ``make_train_step`` fed by ``BatchLoader`` with ``device_mel``,
step after step, as ``train_loop.main`` feeds it.

Traffic parameters: ``samples`` segments of ``seconds`` (a range) of int16
noise at a gain drawn from ``gain``, each with ``cues`` (a range) of
lower-case words, ``chars`` (a range) in all, made from the seed in that
order (the loader does not shuffle); ``micro`` and ``accum``;
``optimizer``: the ``TrainConfig`` numbers, stated here; ``check_steps``;
``ref_chunk`` samples a block of the reference; ``warmup_units`` (after
the checked steps); ``trace_units``; ``ahead`` (default 0): with 0 each
batch is copied to the card as ``train_loop`` copies it, which waits for
the step before; with n > 0 from pinned memory without a wait, and the host
waits only for the step n before the one it has just sent, so that a stall
of the host is hidden by the steps already queued. The transcripts are read with
``only_no_ts_mode`` (``<|startoftranscript|><|notimestamps|> text
<|endoftext|>``), so the reference can build the same ids from the text.

Set-up builds one train state from the seed's weights and drives it
through its first ``check_steps`` steps with the window's own call and
feed, on batches whose rows all differ, keeping each step's loss, the
first gradient's norm per leaf as the optimizer holds it (its first
moment over 1 - beta1 after one step) and the change of each leaf after
the last checked step. The same state then runs the window.

The check (after the window, the program freed): the reference follows
the same steps in fp32 from the same weights and samples, and gives
``loss_gap``, the largest relative gap of a step's loss; ``grad_gap``,
over the leaves, the gap between the norms of the program's and the
reference's first gradient over the larger of the reference leaf's norm
and the median leaf's; ``change_gap``, the same of the leaves' change,
over the leaves whose reference gradient is at least a thousandth of the
median leaf's (the others move by round-off alone). The window's own steps
are held to a finite loss alone."""

from __future__ import annotations

import collections
import gc
import json
import os
from typing import Any, Dict, List

import numpy as np
import torch

from gpubench.weights import PADDING_TOKEN, make_state_dict, norm_seed

TOKENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "reference", "tokens.json")
SAMPLE_RATE = 16000
LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def make_samples(t: Dict[str, Any], seed: int, device: str) -> List[Dict[str, Any]]:
    """The traffic's segments, in order: PCM (int16, a multiple of 16
    samples), cue texts and their times."""
    rng = np.random.default_rng((norm_seed(seed), 11))
    n = t["samples"]
    lo, hi = t["seconds"]
    lengths = (rng.uniform(lo, hi, n) * SAMPLE_RATE).astype(np.int64) // 16 * 16
    gains = rng.uniform(*t["gain"], n)
    gen = torch.Generator(device=device)
    gen.manual_seed(norm_seed(seed) ^ 0x7A1)
    noise = torch.randn(n, max(lengths), generator=gen, device=device)
    noise = (noise * torch.tensor(gains, device=device, dtype=torch.float32)[:, None] * 32768)
    pcm = noise.clamp(-32768, 32767).round().to(torch.int16).cpu().numpy()
    samples = []
    for i in range(n):
        n_cues = int(rng.integers(t["cues"][0], t["cues"][1] + 1))
        n_chars = int(rng.integers(t["chars"][0], t["chars"][1] + 1))
        texts = []
        per = max(n_chars // n_cues - 1, 2)
        for _ in range(n_cues):
            words, left = [], per
            while left > 1:
                w = int(min(rng.integers(2, 9), left))
                words.append(LETTERS[rng.integers(0, 26, w)].tobytes().decode())
                left -= w + 1
            texts.append(" ".join(words))
        dur_ms = int(lengths[i]) // 16
        edges = np.linspace(0, dur_ms, n_cues + 1).astype(int)
        samples.append({"pcm": pcm[i, :lengths[i]].copy(), "texts": texts,
                        "times": [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]})
    return samples


def _ts(ms: int) -> str:
    h, rem = divmod(ms, 3600000)
    m, rem = divmod(rem, 60000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


def reference_ids(texts: List[str], n_ctx: int, tk: Dict[str, Any]):
    """(text_input, text_target) of a sample's cues, padded with
    PADDING_TOKEN: the prompt, each cue's bytes after a space, end of text."""
    ids = list(tk["prompt"])
    for text in texts:
        ids.extend((" " + text.strip()).encode())
    ids.append(tk["eot"])
    ti = np.full(n_ctx, PADDING_TOKEN, np.int64)
    tt = np.full(n_ctx, PADDING_TOKEN, np.int64)
    ti[:len(ids) - 1] = ids[:-1]
    tt[:len(ids) - 1] = ids[1:]
    return ti, tt


class Driver:
    control_needs_window = False

    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.traffic
        self.ahead = self.t.get("ahead", 0) if ctx.device.startswith("cuda") else 0
        self.in_flight: collections.deque = collections.deque()

    def end_to_end(self, window_s: float, counts: Dict[str, Any]) -> Dict[str, float]:
        """The end-to-end values of the measured window, by metric name."""
        return {"train_audio_s_per_s": counts["audio_s"] / window_s}

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        import time

        t0 = time.perf_counter()
        from olmoasr_tpu_torch.api import OLMoASR
        from olmoasr_tpu_torch.models.dims import ModelDimensions
        from olmoasr_tpu_torch.training import dataset as ds
        from olmoasr_tpu_torch.training import train as train_mod

        ctx, t = self.ctx, self.t
        dev = ctx.device
        marks = [("imports", time.perf_counter())]
        self.samples = make_samples(t, ctx.seed, dev)
        marks.append(("inputs", time.perf_counter()))
        if ctx.control:  # the controls replace the program: its inputs alone
            return
        o = t["optimizer"]
        config = train_mod.TrainConfig(
            train_steps=o["train_steps"], eff_batch_size=t["micro"] * t["accum"],
            micro_batch_size=t["micro"], peak_lr=o["peak_lr"], weight_decay=o["weight_decay"],
            beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"], max_grad_norm=o["max_grad_norm"],
            warmup_frac=o["warmup_frac"], remat=True, compute_dtype=torch.bfloat16,
            attention="kernel")
        dims = ModelDimensions(**ctx.dims)
        sd = make_state_dict(ctx.dims, ctx.seed, dev, torch.float32, padding_row=True)
        model = OLMoASR(dims, True, device="meta", dtype=torch.float32)
        model.load_state_dict(sd, assign=True)
        del sd
        model.train()
        self.state = train_mod.TrainState(model, train_mod.make_optimizer(config, model.parameters()))
        self.step_fn = train_mod.make_train_step(dims, config)
        rows = [ds.Sample(audio=s["pcm"],
                          transcript={(_ts(a), _ts(b)): text
                                      for (a, b), text in zip(s["times"], s["texts"])})
                for s in self.samples]
        dataset = ds.AudioTextDataset(rows, dims.n_text_ctx, device_mel=True,
                                      only_no_ts_mode=True)
        self.loader = ds.BatchLoader(dataset, t["micro"], t["accum"], shuffle=False, prefetch=2)
        self.epoch = 0
        self.it = iter(self.loader)
        marks.append(("weights and state", time.perf_counter()))
        self._checked_steps()
        scratch: Dict[str, Any] = {}
        for _ in range(t["warmup_units"]):
            self.unit(scratch)
        self.finish()
        marks.append(("checked steps and warm-up", time.perf_counter()))
        self.setup_phases = {k: b - a for (_, a), (k, b) in zip([("", t0)] + marks, marks)}

    def _checked_steps(self) -> None:
        """The first steps, through ``unit``, with the numbers the check
        compares."""
        b1 = self.t["optimizer"]["beta1"]
        names = [n for n, _ in self.state.model.named_parameters()]
        params = [p for _, p in self.state.model.named_parameters()]
        self.prog = {"loss": []}
        scratch: Dict[str, Any] = {}
        for k in range(self.t["check_steps"]):
            metrics = self.unit(scratch)
            self.prog["loss"].append(float(metrics["loss"]))
            if k == 0:
                opt_state = self.state.optimizer.state
                self.prog["grad"] = {
                    n: float(opt_state[p]["exp_avg"].norm()) / (1 - b1)
                    if "exp_avg" in opt_state.get(p, {}) else 0.0 for n, p in zip(names, params)}
        with torch.no_grad():
            p0 = make_state_dict(self.ctx.dims, self.ctx.seed, self.ctx.device, torch.float32,
                                 padding_row=True)
            self.prog["change"] = {n: float((p - p0[n]).norm()) for n, p in zip(names, params)}
        del p0

    # -- the timed path -------------------------------------------------------

    def _next_batch(self):
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self.it = iter(self.loader)
            return next(self.it)

    def unit(self, counts: Dict[str, Any]):
        ctx, spans = self.ctx, self.ctx.spans
        with spans("loader_wait"):
            batch = self._next_batch()
        with spans("h2d"):
            if self.ahead:
                batch = {k: torch.from_numpy(v).pin_memory().to(ctx.device, non_blocking=True)
                         for k, v in batch.items()}
            else:
                batch = {k: torch.from_numpy(v).to(ctx.device) for k, v in batch.items()}
        with spans("train_step"):
            self.state, metrics = self.step_fn(self.state, batch)
        if self.ahead:
            with spans("step_wait"):
                done = torch.cuda.Event()
                done.record()
                self.in_flight.append(done)
                while len(self.in_flight) > self.ahead:
                    self.in_flight.popleft().synchronize()
        n = self.t["micro"] * self.t["accum"]
        counts["units"] = counts.get("units", 0) + 1
        counts["attempted"] = counts.get("attempted", 0) + n
        counts["samples"] = counts.get("samples", 0) + n
        counts["audio_s"] = counts.get("audio_s", 0.0) + 30.0 * n
        counts.setdefault("losses", []).append(metrics["loss"].detach())
        return metrics

    def finish(self) -> None:
        if self.ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        self.in_flight.clear()

    # -- the check ------------------------------------------------------------

    def _release(self) -> None:
        for name in ("state", "step_fn"):
            self.__dict__.pop(name, None)
        if "it" in self.__dict__:
            self.it.close()
            del self.it
        gc.collect()
        if self.ctx.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def _reference(self, prec, steps: int, fault: str = "") -> Dict[str, Any]:
        """The reference's losses, first gradient norms and changes over
        ``steps`` steps from the seed's weights; ``fault`` plants one of the
        faults a step can have (``half_batch``: the mean over the first half
        of each micro-batch only)."""
        from gpubench.reference import whisper_ref as ref

        ctx, t = self.ctx, self.t
        with open(TOKENS) as f:
            tk = json.load(f)
        p = make_state_dict(ctx.dims, ctx.seed, ctx.device, torch.float32, padding_row=True)
        p0 = {k: v.clone() for k, v in p.items()}
        p = {k: v.requires_grad_(True) for k, v in p.items()
             if k != "encoder.positional_embedding"}
        opt = ref.AdamW(t["optimizer"])
        n_ctx, per_step = ctx.dims["n_text_ctx"], t["micro"] * t["accum"]
        out: Dict[str, Any] = {"loss": []}
        for k in range(steps):
            loss_sum = 0.0
            for m in range(t["accum"]):
                first = (k * per_step + m * t["micro"]) % len(self.samples)
                rows = [self.samples[(first + i) % len(self.samples)] for i in range(t["micro"])]
                if fault == "half_batch":
                    rows = rows[:len(rows) // 2]
                ids = [reference_ids(s["texts"], n_ctx, tk) for s in rows]
                n_valid = sum(int((tt != PADDING_TOKEN).sum()) for _, tt in ids)
                for c in range(0, len(rows), t["ref_chunk"]):
                    block = rows[c:c + t["ref_chunk"]]
                    pcm = np.zeros((len(block), 30 * SAMPLE_RATE), np.float32)
                    for j, s in enumerate(block):
                        pcm[j, :len(s["pcm"])] = s["pcm"] / 32768.0
                    ti = torch.tensor(np.stack([i for i, _ in ids[c:c + len(block)]]),
                                      device=ctx.device)
                    tt = torch.tensor(np.stack([o for _, o in ids[c:c + len(block)]]),
                                      device=ctx.device)
                    with torch.enable_grad():
                        loss = ref.token_loss_sum(p, ctx.dims, torch.from_numpy(pcm).to(ctx.device),
                                                  ti, tt, prec) / n_valid
                        loss.backward()
                    loss_sum += float(loss.detach())
            out["loss"].append(loss_sum / t["accum"])
            grads = {n: v.grad / t["accum"] for n, v in p.items()}
            norm = opt.step(p, grads)
            if k == 0:
                scale = t["optimizer"]["max_grad_norm"] / norm if norm >= t["optimizer"][
                    "max_grad_norm"] else 1.0
                out["grad"] = {n: float(g.norm()) * scale for n, g in grads.items()}
            for v in p.values():
                v.grad = None
        out["change"] = {n: float((v.detach() - p0[n]).norm()) for n, v in p.items()}
        return out

    @staticmethod
    def _gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
        def worst(a: Dict[str, float], b: Dict[str, float], keep) -> float:
            med = float(np.median([b[n] for n in keep]))
            return max(abs(a[n] - b[n]) / max(b[n], med) for n in keep)

        steps = len(ref["loss"])
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"][:steps], ref["loss"]))
        names = list(ref["grad"])
        med_g = float(np.median([ref["grad"][n] for n in names]))
        moved = [n for n in names if ref["grad"][n] >= 1e-3 * med_g]
        return {"loss_gap": loss, "grad_gap": worst(prog["grad"], ref["grad"], names),
                "change_gap": worst(prog["change"], ref["change"], moved)}

    def check(self) -> Dict[str, float]:
        from gpubench.reference import whisper_ref as ref

        ctx, t = self.ctx, self.t
        losses = ctx.window.get("counts", {}).get("losses", [])
        bad = sum(1 for x in losses if not torch.isfinite(x).item())
        ctx.window.setdefault("counts", {})["failed"] = bad
        self._release()
        ref.strict_fp32()
        truth = self._reference(ref.FP32, t["check_steps"])
        if not ctx.control:
            return self._gaps(self.prog, truth)
        out: Dict[str, float] = {}
        for name in ctx.control:
            spec = t["controls"][name]
            prec = ref.Precision(**spec.get("reference", {}))
            other = self._reference(prec, t["check_steps"], spec.get("fault", ""))
            for k, v in self._gaps(other, truth).items():
                out[f"{name}.{k}" if len(ctx.control) > 1 else k] = v
        return out
