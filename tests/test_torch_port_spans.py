"""PyTorch port, the program's spans (``utils/observe.py`` ``span``): off
the profiler one shared no-op that builds no detail; under
``torch.profiler`` the chunk pipeline's spans of ``ASR.transcribe_wavs``
and the step spans of ``Trainer.fit``, counted, nested by time and
tagged with their chunk or step; the encoder's eager ``asr.encode``
inside each chunk's dispatch and each step's step call."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.data.dataset import Batch
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.train.trainer import Trainer
from chinese_asr_tpu_torch.utils import observe


def _small_cfg(tmp_path):
    return (tcfg.Config()
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("decode", max_len=6)
            .with_("train", batch_size=2, num_eval_steps=0,
                   save_dir=str(tmp_path / "ckpt"))
            .replace(verbose=False))


def _rows(prof):
    """(name, start, end, detail) of the trace's ``asr.`` ranges, in order
    of start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end,
                    (getattr(e, "kwinputs", None) or {}).get("detail"))
                   for e in prof.events() if e.name.startswith("asr.")),
                  key=lambda r: r[1])


def _inside(row, outer):
    return outer[1] <= row[1] and row[2] <= outer[2]


def test_span_off_the_profiler_is_one_shared_noop():
    built = []

    def detail():
        built.append(1)
        return "chunk 0"

    assert not torch.autograd._profiler_enabled()
    a, b = observe.span("asr.call", detail), observe.span("asr.prep")
    assert a is b is observe.span("asr.upload", "chunk 1")
    with a:
        pass
    assert built == []
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with observe.span("asr.call", detail):
            pass
    assert built == [1]
    assert [(r[0], r[3]) for r in _rows(prof)] == [("asr.call", "chunk 0")]


def _transcribe(tmp_path):
    """Five wavs at ``max_batch`` 2: three chunks."""
    cfg = _small_cfg(tmp_path)
    asr = tapi.ASR(cfg=cfg, bw=2, wav_bucket=1600, device="cpu",
                   vocab=tapi._identity_vocab(cfg.vocab.vocab_size))
    rng = np.random.RandomState(0)
    wavs = [(rng.randn(3000 + 700 * i) * 6000).astype(np.int16)
            for i in range(5)]
    return lambda: asr.transcribe_wavs(wavs, max_batch=2)


def _fit(tmp_path):
    """Two steps of B=2 through ``Trainer.fit``."""
    cfg = _small_cfg(tmp_path)
    tr = Trainer(cfg, las.init_params(cfg, 0), device="cpu")
    g = torch.Generator().manual_seed(0)

    def batch():
        T, S = 24, 5
        return Batch(torch.randn(2, T, cfg.audio.feat_dim, generator=g),
                     torch.tensor([T, T - 4]),
                     torch.randint(4, 24, (2, S), generator=g),
                     torch.randint(4, 24, (2, S), generator=g),
                     torch.tensor([S, S - 1]))
    batches = [batch() for _ in range(3)]
    return lambda: tr.fit(lambda: iter(batches), max_steps=2)


CASES = {
    "transcribe": (_transcribe, "chunk", 3,
                   {"asr.call": 1, "asr.prep": 3, "asr.upload": 3,
                    "asr.featurize": 3, "asr.dispatch": 3,
                    "asr.finalize": 3, "asr.finalize.wait": 3,
                    "asr.finalize.detok": 3, "asr.encode": 3}),
    "fit": (_fit, "step", 2,
            {"asr.train.load": 2, "asr.train.step": 2, "asr.train.read": 2,
             "asr.train.log": 2, "asr.encode": 2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_under_the_profiler(tmp_path, case):
    make, unit, n, want = CASES[case]
    run = make(tmp_path)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        run()
    rows = _rows(prof)
    got = {}
    for name, *_ in rows:
        got[name] = got.get(name, 0) + 1
    assert got == want
    # every span of the call (or the step) names its chunk (or step),
    # and each chunk or step has one span of each name
    tagged = [r for r in rows if r[0] not in ("asr.call", "asr.encode")
              and not r[0].startswith("asr.finalize.")]
    # the encoder runs eagerly on the CPU: once inside each chunk's
    # dispatch (or each step's step call), tagged with its shape
    outer = "asr.dispatch" if case == "transcribe" else "asr.train.step"
    for enc in [r for r in rows if r[0] == "asr.encode"]:
        assert enc[3].startswith("B ") and " T " in enc[3]
        assert sum(_inside(enc, r) for r in rows if r[0] == outer) == 1
    rows = [r for r in rows if r[0] != "asr.encode"]
    for name in {r[0] for r in tagged}:
        ids = [r[3].split()[1] for r in tagged if r[0] == name]
        assert all(r[3].startswith(unit + " ") for r in tagged
                   if r[0] == name)
        assert len(set(ids)) == len(ids) == n, (name, ids)
    if case == "transcribe":
        call = [r for r in rows if r[0] == "asr.call"][0]
        assert call[3].startswith("call ") and "rows 5 chunks 3" in call[3]
        assert all(_inside(r, call) for r in rows)
        for fin in [r for r in rows if r[0] == "asr.finalize"]:
            kids = [r[0] for r in rows if r is not fin and _inside(r, fin)]
            # on the CPU the result is finished: the wait is empty
            assert kids == ["asr.finalize.wait", "asr.finalize.detok"]
    else:
        steps = [r for r in rows if r[0] == "asr.train.step"]
        assert all(" T 24 S 5" in r[3] for r in steps)
        # load, step, read and log follow one another in each step
        order = [r[0].rsplit(".", 1)[1] for r in rows]
        assert order == ["load", "step", "read", "log"] * 2
