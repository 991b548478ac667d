"""The Conformer (L) configuration (``encoders/conformer.py``,
``configs/las_conformer_l_f32.json``, its offline cell): the family's
frames and FLOPs against a hand count, the cell run at tiny widths on
the CPU, ``conformer_device_ms.offline`` on hand-built records, and on
the card the cell's ``correct`` at its published widths."""

import argparse
import copy
import json
import os

import pytest

from port_bench import encoders, run
from port_bench.lib import common, faults, offline
from port_bench.tests.conftest import TINY_SEED, tiny_config

CONFIG = "las_conformer_l_f32"
CELL = CONFIG + ".offline_aishell_b128"
READER = "conformer_device_ms.offline"

# every kernel of one traced call of the flagship's f32 offline cell, as
# the card's trace names them
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "flagship_f32_kernels.json")) as f:
    FLAGSHIP_KERNELS = json.load(f)["kernels"]


# ---- frames and FLOPs --------------------------------------------------------
def test_frames_and_flops_by_hand():
    """A row of 100 frames at the tiny widths (d 32, FFN 64, kernel 8, 2
    blocks, 80 mels): conv1 49 x 39 outputs of 9 taps, conv2 24 x 19 of 9
    x 32, the linear 24 x 608 -> 32; a block over L = 24."""
    cfg = tiny_config(common.load("configs", CONFIG))
    fam = encoders.of(cfg)
    assert fam.frames(100, cfg) == 24
    assert [fam.frames(n, cfg) for n in (1, 6, 7, 10, 11)] == [0, 0, 1, 1, 2]
    d, f, k, L = 32, 64, 8, 24
    sub = 2 * (49 * 39 * 32 * 9) + 2 * (24 * 19 * 32 * 9 * 32) \
        + 2 * (24 * 608 * 32)
    mac = (2 * (L * d * f + L * f * d)            # the two FFNs
           + L * d * 3 * d                        # Q, K, V
           + (2 * L - 1) * d * d                  # R W_pos
           + 3 * L * L * d                        # content, position, context
           + L * d * d                            # W_o
           + L * d * 2 * d + L * d * k + L * d * d)   # the conv module
    assert fam.flops(cfg, 100) == sub + 2 * 2 * mac
    assert fam.flops(cfg, 6) == 0.0
    assert fam.enc_size(cfg) == d


# ---- the cell at tiny widths ---------------------------------------------------
def _run(trace=0):
    args = argparse.Namespace(workload=CELL, seed=TINY_SEED + 22, seconds=0.5,
                              trace=trace)
    return run.run_cell(args, device="cpu")


def test_the_cell_runs_at_tiny_widths(tiny):
    result, checks = _run()
    assert result["correct"], checks
    assert {"audio_s_per_s", "setup_s"} <= set(result["metrics"])
    with faults.FAULTS["answer_altered"]():
        result, checks = _run()
    assert not result["correct"], checks


# ---- the reader ------------------------------------------------------------------
def _rec(blocks=34, glu=34, encoder_type="CONFORMER"):
    cfg = copy.deepcopy(common.load("configs", CONFIG))
    cfg["encoder"]["encoder_type"] = encoder_type
    kernels = {k: (0.5, 1) for k in FLAGSHIP_KERNELS}
    kernels.update({
        "void at::native::elementwise_kernel<128, 2, glu_kernel(x)>": (0.002, glu),
        "void at::native::vectorized_elementwise_kernel<4, silu_kernel(x)>":
            (0.003, 68),
        "void vectorized_layer_norm_kernel<float, float, false>": (0.005, 170),
        "void softmax_warp_forward<float, float, float, 9, false, false>":
            (0.007, 34),
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": (
            0.011, 6),
        "void conv_depthwise2d_forward_kernel_generic<float, int>": (
            0.013, 34),
        "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>": (
            0.017, 34),
    })
    return {"kind": "offline", "cfg": cfg, "kernels": common.kernel_maps(),
            "trace": {"work": [{}, {}], "counted": {"conformer.blocks": blocks},
                      "kernels": kernels}}


def test_the_reader_sums_the_conformers_kernels_a_chunk():
    read = common.reader(READER)
    assert read(_rec()) == pytest.approx(1e3 * 0.058 / 2)
    assert read(_rec(blocks=33)) is None        # not 17 blocks a chunk
    assert read(_rec(glu=33)) is None           # a GLU record lost
    assert read(_rec(encoder_type="LSTM")) is None
    assert read(dict(_rec(), trace=None)) is None


def test_the_readers_names_match_none_of_the_flagships_kernels():
    mod = common.reader(READER).__globals__
    names = list(mod["NAMES"]) + [
        n for m in common.kernel_maps().values() for n in m["names"]
        if m["counters"][0][0].endswith("conformer")]
    for k in FLAGSHIP_KERNELS:
        assert not any(n in k for n in names), k


# ---- on the card -------------------------------------------------------------------
@pytest.mark.cuda
def test_the_cell_is_correct_at_full_width_on_the_card(card):
    """The program at the published widths on 256 of the cell's wavs,
    judged on 8 rows by the reference at full width."""
    cell = common.load("workloads", CELL)
    cfg = common.load("configs", CONFIG)
    mix = common.load("traffic", cell["traffic"])
    mix = dict(mix, lengths=dict(mix["lengths"], count=256))
    cell = dict(cell, check=dict(cell["check"], sample=8))
    drv = offline.Driver(cell, cfg, mix, TINY_SEED, device=card)
    drv.setup()
    drv.call()
    drv.release()
    ok, checks = common.judge(drv.check(), cell["check"]["limits"])
    assert ok, checks
