"""Training -> inference checkpoint conversion, and its command line.

Counterpart of ``olmoasr_tpu/models/gen_inf_ckpt.py`` (the reference's
``scripts/eval/gen_inf_ckpt.py``): the padding-token embedding row (id
51864) is dropped, so that the inference model's vocabulary is exactly
51864, and the weights are written in the JAX package's ``.npz`` format.
Reads a reference ``.pt`` or an ``.npz``, on the port's ``convert``.

    python -m olmoasr_tpu_torch.models.gen_inf_ckpt train.pt inference.npz
"""

from __future__ import annotations

from olmoasr_tpu_torch.models.convert import (
    load_npz_checkpoint,
    load_torch_checkpoint,
    save_npz_checkpoint,
    strip_padding_row,
)


def gen_inf_ckpt(ckpt_path: str, save_path: str) -> str:
    """``ckpt_path`` (``.npz`` or ``.pt``) without its padding row, written
    to ``save_path`` as ``.npz``; returns ``save_path``."""
    if ckpt_path.endswith(".npz"):
        sd, dims = load_npz_checkpoint(ckpt_path)
    else:
        sd, dims = load_torch_checkpoint(ckpt_path)
    save_npz_checkpoint(save_path, strip_padding_row(sd), dims)
    return save_path


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("ckpt_path")
    p.add_argument("save_path")
    a = p.parse_args()
    gen_inf_ckpt(a.ckpt_path, a.save_path)
