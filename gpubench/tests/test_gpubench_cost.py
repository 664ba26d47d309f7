"""The yardstick's counts against hand reckonings at published widths."""

import json
import os

import pytest

from gpubench import core, cost

SMALL = json.load(open(os.path.join(core.HERE, "configs", "small.en.json")))["dims"]
LARGE = json.load(open(os.path.join(core.HERE, "configs", "large.en-v2.json")))["dims"]
H100 = cost.peaks("NVIDIA H100 80GB HBM3")


def test_peaks():
    assert H100["bf16_flops_per_s"] == 989e12 and H100["hbm_bytes_per_s"] == 3.35e12
    assert cost.peaks("some other card") is None


def test_train_flops_per_sample():
    # small.en: conv 6.41 GFLOP, 12 encoder layers of 28.15 GFLOP, 12 decoder
    # layers of 13.62 GFLOP, logits 35.69 GFLOP: 543.3 GFLOP forward, x3
    assert cost.train_flops_per_sample(SMALL) == pytest.approx(1.63e12, rel=2e-3)
    assert cost.train_flops_per_sample(LARGE) == pytest.approx(10.34e12, rel=2e-3)


def test_train_flops_match_the_port():
    from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
    from olmoasr_tpu_torch.training.train import train_flops_per_sample

    for name, dims in (("small.en", SMALL), ("large.en-v2", LARGE)):
        assert cost.train_flops_per_sample(dims) == train_flops_per_sample(VARIANT_TO_DIMS[name])


def test_encoder_and_decoder_flops():
    # small.en encoder: 12 x (24 * 1500 * 768^2 + 4 * 1500^2 * 768) + conv
    enc = 12 * (24 * 1500 * 768 ** 2 + 4 * 1500 ** 2 * 768) + 6.4143e9
    assert cost.encoder_flops_per_window(SMALL) == pytest.approx(enc, rel=1e-4)
    assert cost.cross_kv_flops_per_window(SMALL) == 12 * 4 * 1500 * 768 ** 2
    # a token at position 0: 28 d^2 + 4 d + 4 * 1500 d a layer, logits 2 d V
    tok = 12 * (28 * 768 ** 2 + 4 * 768 + 6000 * 768) + 2 * 768 * 51864
    assert cost.decoder_flops_per_token(SMALL, 0) == tok


def test_cross_kv_bytes_and_row_1_bound():
    # 55.3 MB of bf16 cross K/V a window over small.en's 12 layers
    call = cost.cross_attend_call(SMALL, 1, 2)
    kv = call["bytes"] - 768 * 4 - 768 * 2
    assert 12 * kv == 55_296_000
    # row 1's attention at B=64: 0.088 ms of bytes (the kernel table's bound)
    call = cost.cross_attend_call(SMALL, 64, 2)
    assert cost.least_time_s(call["ops"], call["bytes"], H100) == pytest.approx(88.1e-6, rel=2e-3)


def test_row_7_bound():
    # row 7 at B=64, offset 224, small.en: 0.0596 ms (the kernel table's bound)
    call = cost.layer_block_call(SMALL, 64, 224)
    assert cost.least_time_s(call["ops"], call["bytes"], H100) == pytest.approx(59.6e-6, rel=3e-3)
    # large.en-v2 at 128 windows: 15.7 GB of int8 cross K/V a step
    kv = 32 * 2 * 128 * 1500 * 1280
    assert kv == pytest.approx(15.7e9, rel=2e-3)
    call = cost.layer_block_call(LARGE, 128, 0)
    assert 32 * call["bytes"] > kv


def test_train_attention_is_ops_bound():
    # forward: 12 x 4 x 1500^2 x 768 + 12 x (2 x 448 x 449 x 768 + 4 x 448 x 1500 x 768)
    fwd = 12 * 4 * 1500 ** 2 * 768 + 12 * (2 * 448 * 449 * 768 + 4 * 448 * 1500 * 768)
    work = cost.train_attention_per_sample(SMALL)
    assert work["ops"] == 3 * fwd
    assert work["ops"] / H100["bf16_flops_per_s"] > work["bytes"] / H100["hbm_bytes_per_s"]
