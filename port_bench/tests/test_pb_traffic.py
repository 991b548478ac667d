"""The traffic generator: the same seed gives the same inputs, every
seed the same set of lengths, and the mixes have AISHELL-1's shape."""

import numpy as np
import pytest

from port_bench.lib import common, traffic

MIXES = ["aishell_offline_b128", "aishell_train_b256"]


def small(mix, n=40):
    mix = dict(mix, lengths=dict(mix["lengths"], count=n))
    return mix


@pytest.mark.parametrize("name", MIXES)
def test_aishell_shape(name):
    mix = common.load("traffic", name)
    s = traffic.lengths_s(mix["lengths"])
    assert len(s) == mix["lengths"]["count"]
    assert 4.3 <= s.mean() <= 4.7              # AISHELL-1: 178 h / 141,600
    assert s.min() >= 1.5 and s.max() <= 14.5
    assert np.all(np.diff(s) >= 0)
    # the shape and its spread are assumptions, named with the range
    # they realise
    assumed = " ".join(mix["assumed"])
    assert "log-normal" in assumed and "sigma 0.33" in assumed
    assert f"1.5-{s.max():.1f} s" in assumed


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_gives_the_same_corpus(name):
    mix = small(common.load("traffic", name))
    a, sa = traffic.corpus(mix, 2 ** 31 + 7, "cpu")
    b, sb = traffic.corpus(mix, 2 ** 31 + 7, "cpu")
    c, sc = traffic.corpus(mix, 3, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(sa, sb)
    # another seed: the same lengths in another order, other audio
    assert sorted(len(x) for x in a) == sorted(len(x) for x in c)
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))
    assert all(x.dtype == np.int16 for x in a)
    assert all(len(x) == round(s * 16000) for x, s in zip(a, sa))


def test_speech_like_signal_is_not_silent_or_clipped():
    w = traffic.speech_like(np.array([16000, 24000]), 5, "cpu")
    for x in w:
        assert 2000 < np.abs(x.astype(np.int32)).max() < 32767
        assert np.abs(x.astype(np.float64)).mean() > 300


def test_transcripts_follow_the_rate():
    mix = common.load("traffic", "aishell_train_b256")
    secs = np.array([1.5, 4.5, 10.0])
    t = traffic.transcripts(secs, mix, 11, 5004, 4)
    assert [len(x) for x in t] == [5, 14, 32]
    assert all(((x >= 4) & (x < 5004)).all() for x in t)
    assert all(np.array_equal(x, y) for x, y in
               zip(t, traffic.transcripts(secs, mix, 11, 5004, 4)))
