"""PyTorch port: featurizer parity with the JAX package (CPU, plain K1 twin).

Tolerances: features are float32 on both sides, but XLA:CPU and torch sum
the DFT/mel products and the instance-norm statistics in different
orders, so values agree to f32 reassociation, not bit for bit.  Log-mel
is compared at atol 1e-4 + rtol 1e-4: low-energy bins carry the DFT
sums' cancellation error, measured up to 2.7e-4 absolute at log values
near -7 on white noise; instance-normed features at atol 2e-4 (unit-scale values, errors
amplified by at most 1/std of a row).  Pure data movement (flat-wire
unpack, frame counts) is compared exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.audio import features as jfeat
from chinese_asr_tpu.ops.pallas import logmel as jlogmel
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features as tfeat
from chinese_asr_tpu_torch.ops.cuda import logmel as tlogmel

from torch_port_util import N, T, golden_cfg, pad_batch, random_wavs

ATOL_LOGMEL = 1e-4
RTOL_LOGMEL = 1e-4
ATOL_FEATS = 2e-4


def _audio_cfgs():
    return {"flagship": (jcfg.AudioConfig(), tcfg.AudioConfig()),
            "golden": (golden_cfg(jcfg).audio, golden_cfg(tcfg).audio),
            "deltas_no_stack": (
                jcfg.AudioConfig(downsample=False),
                tcfg.AudioConfig(downsample=False)),
            "stack_no_deltas": (
                jcfg.AudioConfig(delta_delta=False),
                tcfg.AudioConfig(delta_delta=False))}


@pytest.mark.parametrize("name", list(_audio_cfgs()))
@pytest.mark.parametrize("int16", [True, False])
def test_featurize_batch_matches_jax(name, int16):
    jc, tc = _audio_cfgs()[name]
    rng = np.random.default_rng(7)
    wavs = random_wavs(rng, [12000, 7300, 300], int16=int16)   # 3rd < 1 frame
    mat, lens = pad_batch(wavs, 16000)
    scale = np.array([1.0, 0.7, 2.0], np.float32)
    jf, jl = jfeat.featurize_batch(jnp.asarray(mat), jnp.asarray(lens), jc,
                                   norm_eps=1e-6, scale=jnp.asarray(scale))
    tf_, tl = tfeat.featurize_batch(T(mat), T(lens), tc, norm_eps=1e-6,
                                    scale=T(scale))
    assert tf_.shape == jf.shape and tf_.dtype == torch.float32
    np.testing.assert_array_equal(N(tl), N(jl))
    np.testing.assert_allclose(N(tf_), N(jf), rtol=0, atol=ATOL_FEATS)


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_featurize_flat_matches_jax(dtype):
    jc, tc = jcfg.AudioConfig(), tcfg.AudioConfig()
    rng = np.random.default_rng(3)
    wavs = random_wavs(rng, [9000, 15000, 4000], int16=dtype == np.int16)
    lens = np.array([len(w) for w in wavs], np.int32)
    flat = np.zeros(32000 + 17, dtype)
    flat[: lens.sum()] = np.concatenate(wavs)
    Nmax = 16000
    np.testing.assert_array_equal(
        N(tfeat.unpack_flat(T(flat), T(lens), Nmax)),
        N(jfeat.unpack_flat(jnp.asarray(flat), jnp.asarray(lens), Nmax)))
    jf, jl = jfeat.featurize_flat(jnp.asarray(flat), jnp.asarray(lens), Nmax,
                                  jc, norm_eps=1e-6)
    tf_, tl = tfeat.featurize_flat(T(flat), T(lens), Nmax, tc, norm_eps=1e-6)
    np.testing.assert_array_equal(N(tl), N(jl))
    np.testing.assert_allclose(N(tf_), N(jf), rtol=0, atol=ATOL_FEATS)


@pytest.mark.parametrize("n", [16000, 24011])
def test_plain_log_mel_matches_jax_and_pallas(n):
    jc, tc = jcfg.AudioConfig(), tcfg.AudioConfig()
    rng = np.random.default_rng(n)
    wav = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    Tn = int(jfeat.num_frames(n, jc))
    mask = (np.arange(Tn)[None] < np.array([[Tn], [Tn - 9]])).astype(np.float32)
    ref = N(jfeat.log_mel(jnp.asarray(wav), Tn, jc, jnp.asarray(mask)))
    pal = N(jlogmel.log_mel(jnp.asarray(wav), Tn, jc, jnp.asarray(mask),
                            interpret=True))
    got = N(tfeat.log_mel(T(wav), Tn, tc, T(mask)))
    assert got.shape == (2, Tn, tc.n_mels)
    np.testing.assert_allclose(got, ref, rtol=RTOL_LOGMEL, atol=ATOL_LOGMEL)
    np.testing.assert_allclose(got, pal, rtol=RTOL_LOGMEL, atol=ATOL_LOGMEL)
    assert np.abs(got[1, Tn - 9:]).max() == 0.0


def test_log_mel_kernel_contract_on_cpu_is_the_twin():
    """The K1 wrapper takes the plain twin for a CPU tensor (and counts no
    launch); samples past a row's end read as zero."""
    tc = tcfg.AudioConfig()
    wav = torch.randn(2, 4000)
    before = tlogmel.launches
    out = tlogmel.log_mel(wav, 30, tc)            # frames past the end
    assert tlogmel.launches == before
    torch.testing.assert_close(out, tlogmel.log_mel_plain(wav, 30, tc),
                               rtol=0, atol=0)
    assert out.shape == (2, 30, tc.n_mels) and torch.isfinite(out).all()


def test_constants_and_frame_counts_match_jax():
    jc, tc = jcfg.AudioConfig(), tcfg.AudioConfig()
    for a, b in zip(jfeat._constants(jc), tfeat._constants(tc)):
        np.testing.assert_array_equal(a, b)
    n = np.array([0, 1, 300, 512, 513, 673, 16000, 160000])
    np.testing.assert_array_equal(
        N(tfeat.num_frames(T(n), tc)), np.asarray(jfeat.num_frames(n, jc)))
    np.testing.assert_array_equal(
        N(tfeat.feat_len_from_samples(T(n), tc)),
        np.asarray(jfeat.feat_len_from_samples(n, jc)))
    assert tfeat.num_frames(160000, tc) == jfeat.num_frames(160000, jc) == 997


def test_delta_paths_and_instance_norm_match_jax():
    rng = np.random.default_rng(5)
    lm = rng.standard_normal((2, 20, 6)).astype(np.float32)
    np.testing.assert_allclose(N(tfeat.deltas_stack3(T(lm))),
                               N(jfeat.deltas_stack3(jnp.asarray(lm))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        N(tfeat.stack3(tfeat.add_delta_deltas(T(lm)))),
        N(jfeat.stack3(jfeat.add_delta_deltas(jnp.asarray(lm)))),
        rtol=0, atol=1e-6)
    assert tfeat.deltas_stack3(T(lm[:, :2])).shape == (2, 0, 54)
    mask = (np.arange(20)[None] < np.array([[20], [13]])).astype(np.float32)
    np.testing.assert_allclose(
        N(tfeat.instance_norm(T(lm), T(mask), eps=1e-6)),
        N(jfeat.instance_norm(jnp.asarray(lm), jnp.asarray(mask), eps=1e-6)),
        rtol=0, atol=1e-5)
