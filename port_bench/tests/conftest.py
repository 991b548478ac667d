"""Tiny variants of the benchmark's cells for the CPU tests: the
configurations' files with small widths, the mixes with a few short
utterances, found by name as the harness finds the real ones."""

import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench import encoders  # noqa: E402
from port_bench.lib import common  # noqa: E402

TINY_SEED = 2 ** 31 + 12345


def tiny_config(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["encoder"] = encoders.of(cfg).tiny(cfg["encoder"])
    cfg["decoder"].update(hidden_size=32, embed_dim=8)
    cfg["attention"]["attn_size"] = 8
    cfg["vocab"]["max_num_words"] = 60
    cfg["decode"]["max_len"] = 6
    cfg["beam_width"] = 3
    return cfg


def tiny_mix(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    if mix["kind"] == "train":
        mix["lengths"].update(count=12, median_s=0.6, min_s=0.3, max_s=1.2)
        mix["batch_size"] = 4
    else:
        mix["lengths"].update(count=7, median_s=0.6, min_s=0.3, max_s=1.2)
        mix["max_batch"] = 3
    return mix


@pytest.fixture
def tiny(monkeypatch):
    """``common.load`` answering with tiny variants and a sample of 4."""
    real = common.load

    def load(kind, name):
        x = real(kind, name)
        if kind == "configs":
            return tiny_config(x)
        if kind == "traffic":
            return tiny_mix(x)
        if kind == "workloads" and "sample" in x["check"]:
            x = copy.deepcopy(x)
            x["check"]["sample"] = 4
        return x

    monkeypatch.setattr(common, "load", load)
    return load


@pytest.fixture
def card():
    """Skips where no card is present (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
