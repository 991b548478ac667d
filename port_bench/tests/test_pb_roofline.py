"""The roofline and model-FLOP formulas on hand-worked shapes."""

import pytest

from port_bench.lib import common
from port_bench.roofline import (common as rc, k1, k2, k2_bwd, k3, model,
                                 shapes)

CFG = common.load("configs", "las_blstm_f32")


def test_peaks():
    p = rc.peaks()
    assert p["flops_per_s"]["float32"] == 495e12 / 3
    assert p["flops_per_s"]["bfloat16"] == 989e12
    assert p["hbm_bytes_per_s"] == 3.35e12


def test_bound_is_the_larger_of_the_two():
    assert rc.bound_s(165e12, 0, "float32") == pytest.approx(1.0)
    assert rc.bound_s(0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert rc.bound_s(1.65e12, 3.35e12, "float32") == pytest.approx(1.0)


def test_frames():
    a = CFG["audio"]
    # 1 s: 15999 samples after pre-emphasis, 1 + (15999 - 512) // 160
    assert shapes.frames(16000, a) == 97
    assert shapes.encoder_frames(16000, a) == 32
    assert shapes.encoder_frames(600, a) == 1


def test_k1():
    ops, nbytes = k1.work(B=2, N=16001, T=97)
    per_frame = 2.5 * 512 * 9 + 3 * 257 + 2 * 257 * 80 + 80
    assert ops == pytest.approx(2 * 97 * per_frame)
    assert nbytes == 4 * 2 * 16000 + 4 * 2 * 97 * 80


def test_k2():
    ops, nbytes = k2.work(T=10, B=2, H=4, valid_steps=15, elem_bytes=4)
    assert ops == 2 * 15 * (2 * 4 * 16 + 40)
    assert nbytes == 4 * (2 * 10 * 2 * 16 + 2 * 10 * 2 + 2 * 4 * 16
                          + 2 * 10 * 2 * 4 + 2 * 2 * 2 * 4)
    assert k2.work(10, 2, 4, 15, 2)[1] == nbytes // 2


def test_k2_bwd():
    ops, nbytes = k2_bwd.work(T=10, B=2, H=4, valid_steps=15)
    assert ops == 2 * 15 * (2 * 2 * 4 * 16 + 80)
    # reads xg x2, masks, W_hh, ys x2, gy x2, ghT, gcT; writes dxg, hs, cs
    reads = 2 * 320 + 2 * 20 + 128 + 4 * 80 + 2 * 16
    writes = 2 * 320 + 2 * 80 + 2 * 80
    assert nbytes == 4 * (reads + writes)


def test_k3():
    ops, nbytes = k3.work(R=2048, V=5004, k=17)
    assert nbytes == 4 * 2048 * 5004 + 8 * 2048 * 17
    assert ops == 2048 * 5004


def test_model_flops():
    # the flagship at F = 100 encoder frames, by hand
    F, D, H, Hd, E, A, V = 100, 720, 256, 512, 256, 128, 5004
    enc = 2 * (2 * F * D * 4 * H + 2 * F * H * 4 * H) \
        + 3 * 2 * (2 * F * 2 * H * 4 * H + 2 * F * H * 4 * H) \
        + 2 * F * 2 * H * A
    step = (2 * (E + 2 * H) * 4 * Hd + 2 * Hd * 4 * Hd + 2 * Hd * A
            + 2 * F * A + 2 * F * 2 * H + 2 * (Hd + 2 * H) * V)
    assert model.encoder_flops(CFG, F) == enc
    assert model.decoder_step_flops(CFG, F) == step
    assert model.decode_flops(CFG, F, 16, 40) == enc + 16 * 40 * step
    assert model.train_flops(CFG, F, 15) == 3 * (enc + 15 * step)
