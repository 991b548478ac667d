"""The E-Branchformer (L) configuration (``encoders/e_branchformer.py``,
``configs/las_ebranchformer_l_f32.json``, its offline cell): the
family's contract, its layout against the program's tree, its frames and
FLOPs against a hand count, the cell run at tiny widths on the CPU,
``ebranchformer_device_ms.offline`` on hand-built records, and on the
card the cell's ``correct`` at its published widths."""

import argparse
import copy
import json
import math
import os

import pytest
import torch

from port_bench import encoders, run
from port_bench.lib import common, faults, offline, weights
from port_bench.reference import las as ref
from port_bench.tests.conftest import TINY_SEED, tiny_config

CONFIG = "las_ebranchformer_l_f32"
CELL = CONFIG + ".offline_aishell_b128"
READER = "ebranchformer_device_ms.offline"

# every kernel of one traced call of the flagship's f32 offline cell, as
# the card's trace names them
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "flagship_f32_kernels.json")) as f:
    FLAGSHIP_KERNELS = json.load(f)["kernels"]


# ---- the family's contract --------------------------------------------------
def test_the_family_keeps_the_contract():
    """Found by its ``encoder_type``; each function of
    ``encoders/__init__.py`` answers at tiny widths: the width, a layout
    of (path, shape, init) the weights draw, frames, FLOPs, and an
    encoding of that width with the decoder's zero start."""
    cfg = tiny_config(common.load("configs", CONFIG))
    fam = encoders.of(cfg)
    assert fam is encoders.load("E_BRANCHFORMER")
    assert fam.tiny(cfg["encoder"]) == cfg["encoder"]
    assert fam.enc_size(cfg) == 32
    for path, shape, init in fam.layout(cfg):
        assert path[0] == "encoder" and all(n > 0 for n in shape)
        assert isinstance(init, float) or init == "ones"
    params = weights.make_params(cfg, TINY_SEED, "cpu")
    g = torch.Generator().manual_seed(0)
    x, lens = torch.randn(2, 30, 80, generator=g), torch.tensor([30, 20])
    x[1, 20:] = 0.0
    enc, out_lens, (h, c) = fam.encode(ref.Precision(), params, x, lens, cfg)
    assert out_lens.tolist() == [fam.frames(30, cfg), fam.frames(20, cfg)]
    assert enc.shape == (2, fam.frames(30, cfg), 32)
    assert not enc[1, int(out_lens[1]):].any()
    assert h.shape == c.shape == (2, cfg["decoder"]["hidden_size"])
    assert not h.any() and not c.any()
    assert fam.flops(cfg, 30) > 0 and fam.blocks >= 0


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_the_layout_is_the_programs_tree(width):
    """The program's ``init_encoder`` makes, leaf by leaf in path and
    shape, the tree the benchmark draws from the family's layout; at full
    width 116,007,936 parameters."""
    from chinese_asr_tpu_torch.models import encoder as tenc
    from chinese_asr_tpu_torch.models import las
    cfg = common.load("configs", CONFIG)
    if width == "tiny":
        cfg = tiny_config(cfg)
    tree = tenc.init_encoder(torch.Generator(), offline.port_config(cfg))
    got = {"/".join(map(str, p)): tuple(t.shape)
           for p, t in las.tree_paths({"encoder": tree})}
    want = {"/".join(map(str, p)): tuple(s)
            for p, s, _ in encoders.of(cfg).layout(cfg)}
    assert got == want
    if width == "full":
        assert sum(math.prod(s) for s in want.values()) == 116_007_936


# ---- frames and FLOPs -------------------------------------------------------
def test_frames_and_flops_by_hand():
    """A row of 100 frames at the tiny widths (d 32, FFN 64, cgMLP 96 of
    kernel 7, merge kernel 5, 2 blocks, 80 mels): the Conformer family's
    subsampling (conv1 49 x 39 outputs of 9 taps, conv2 24 x 19 of 9 x 32,
    the linear 24 x 608 -> 32); a block over L = 24."""
    cfg = tiny_config(common.load("configs", CONFIG))
    fam = encoders.of(cfg)
    assert fam.frames(100, cfg) == 24
    assert [fam.frames(n, cfg) for n in (1, 6, 7, 10, 11)] == [0, 0, 1, 1, 2]
    d, f, C, k, mk, L = 32, 64, 96, 7, 5, 24
    sub = 2 * (49 * 39 * 32 * 9) + 2 * (24 * 19 * 32 * 9 * 32) \
        + 2 * (24 * 608 * 32)
    mac = (2 * (L * d * f + L * f * d)            # the two FFNs
           + L * d * 3 * d                        # Q, K, V
           + (2 * L - 1) * d * d                  # R W_pos
           + 3 * L * L * d                        # content, position, context
           + L * d * d                            # W_o
           + L * d * C + L * (C // 2) * k         # cgMLP: in, depthwise,
           + L * (C // 2) * d                     # out
           + L * 2 * d * mk + L * 2 * d * d)      # the merge
    assert fam.flops(cfg, 100) == sub + 2 * 2 * mac
    assert fam.flops(cfg, 6) == 0.0


# ---- the cell at tiny widths ------------------------------------------------
def _run(trace=0):
    args = argparse.Namespace(workload=CELL, seed=TINY_SEED + 26, seconds=0.5,
                              trace=trace)
    return run.run_cell(args, device="cpu")


def test_the_cell_runs_at_tiny_widths(tiny):
    result, checks = _run()
    assert result["correct"], checks
    assert {"audio_s_per_s", "setup_s"} <= set(result["metrics"])
    with faults.FAULTS["answer_altered"]():
        result, checks = _run()
    assert not result["correct"], checks


# ---- the reader -------------------------------------------------------------
GELU = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::GeluCUDAKernelImpl(at::TensorIteratorBase&, "
        "at::native::GeluType)::{lambda()#1}>")


def _rec(blocks=34, gelu=34, encoder_type="E_BRANCHFORMER"):
    cfg = copy.deepcopy(common.load("configs", CONFIG))
    cfg["encoder"]["encoder_type"] = encoder_type
    kernels = {k: (0.5, 1) for k in FLAGSHIP_KERNELS}
    kernels.update({
        GELU: (0.002, gelu),
        "void at::native::vectorized_elementwise_kernel<4, silu_kernel(x)>":
            (0.003, 68),
        "void vectorized_layer_norm_kernel<float, float, false>": (0.005, 238),
        "void softmax_warp_forward<float, float, float, 9, false, false>":
            (0.007, 34),
        "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw": (
            0.011, 6),
        "void conv_depthwise2d_forward_kernel_generic<float, int>": (
            0.013, 68),
        "void at::native::CatArrayBatchedCopy<float, unsigned int, 3>": (
            0.017, 34),
    })
    return {"kind": "offline", "cfg": cfg, "kernels": common.kernel_maps(),
            "trace": {"work": [{}, {}],
                      "counted": {"e_branchformer.blocks": blocks},
                      "kernels": kernels}}


def test_the_reader_sums_the_encoders_kernels_a_chunk():
    """The six kinds of kernel only this encoder launches, a chunk; not the
    concatenation, which the decoder launches too."""
    read = common.reader(READER)
    assert read(_rec()) == pytest.approx(1e3 * 0.041 / 2)
    assert read(_rec(blocks=33)) is None        # not 17 blocks a chunk
    assert read(_rec(gelu=33)) is None          # a GELU record lost
    assert read(_rec(encoder_type="LSTM")) is None
    assert read(dict(_rec(), trace=None)) is None


def test_the_reader_reads_none_on_a_conformer_record():
    """A traced Conformer call (its GLU marker and ``conformer.blocks``,
    no E-Branchformer count) reads None, and the Conformer's own reader
    reads None on an E-Branchformer record."""
    conf = copy.deepcopy(_rec(encoder_type="CONFORMER"))
    conf["cfg"] = common.load("configs", "las_conformer_l_f32")
    conf["trace"]["counted"] = {"conformer.blocks": 34}
    assert common.reader(READER)(conf) is None
    assert common.reader("conformer_device_ms.offline")(_rec()) is None


def test_the_readers_names_match_none_of_the_flagships_kernels():
    mod = common.reader(READER).__globals__
    names = list(mod["NAMES"]) + [
        n for m in common.kernel_maps().values() for n in m["names"]
        if m["counters"][0][0].endswith("e_branchformer")]
    assert "GeluCUDAKernelImpl" in names
    for k in FLAGSHIP_KERNELS:
        assert not any(n in k for n in names), k


# ---- on the card ------------------------------------------------------------
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
