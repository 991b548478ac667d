"""K6, the beam's additive-attention read (``csrc/attention.cu``), modelled
in numpy on the CPU and held against its plain twin and the JAX
package's ``attend_beam``; and ``plan``, which spreads a launch.

The model follows the kernel: the frames from the last one whose mask is
not -inf onward are not computed (score -inf); the tiles of ``plan``'s
``tile`` frames, each warp taking 32 frames of one beam (lane = frame) in
the kernel's order of warp items; each (beam, frame) dot product over a
in index order as float32 multiply-adds of tanh(key + q) and v; the
softmax a warp a beam, each lane's strided partial max and sum of
exp(s - max) in float32, combined by the xor butterfly, and align =
exp(s - max) / sum.  The kernel's tanhf and expf are not numpy's, and a
multiply-add is emulated in float64 then rounded, so the model agrees
with the twin to the summation order (1e-5 absolute, the bound the
kernel is held to on the card).  bf16 operands are widened to float32
and only align is rounded to bf16.  Inputs are made with numpy from a
seed.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu.config import AttentionConfig as JAttentionConfig
from chinese_asr_tpu.models import attention as jattn
from chinese_asr_tpu_torch.config import AttentionConfig
from chinese_asr_tpu_torch.models import attention as tattn
from chinese_asr_tpu_torch.ops.cuda import attention as ak

F32 = np.float32
TOL = 1e-5          # the summation order over a (and of the softmax's sum)
# bf16 K6 against the bf16 twin, which rounds the sum, tanh, the product
# with v and the sum over a to bf16 before its softmax: a score's rounding
# (2^-9 of |score| <= 4) moves its softmax weight by up to ~0.8 % of
# itself, and align's own rounding 2^-9 of it: ~1.2e-2 at align 1
TOL_BF16_TWIN = 1.6e-2


def inputs(B, k, L, a, seed, lens=None, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((B, L, a)).astype(F32)
    q = rng.standard_normal((B, k, a)).astype(F32)
    v = (0.1 * rng.standard_normal(a)).astype(F32)
    if lens is None:
        lens = rng.integers(1, L + 1, B)
        lens[0] = L
    mask = np.where(np.arange(L)[None] < np.asarray(lens)[:, None], 0.0,
                    -np.inf).astype(F32)
    ts = [torch.from_numpy(x).to(dtype) for x in (mask, q, keys, v)]
    return ts, [t.float().numpy() for t in ts]


def fma(x, y, z):
    return (x.astype(np.float64) * y + z).astype(F32)


def butterfly(x, op):
    """The kernel's xor-shuffle reduction over the last axis (32 lanes):
    every lane ends with the same value."""
    x = x.copy()
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[..., np.arange(32) ^ o]).astype(F32)
    return x[..., 0]


def k6_model(mask, q, keys, v, plan, out_dtype=torch.float32):
    """align [B, k, L] as K6 computes it under ``plan``; also the (beam,
    frame) pairs each tile's warps computed, to check their coverage."""
    B, k, a = q.shape
    L = keys.shape[1]
    kb, tile, W = plan["beams_per_block"], plan["tile"], plan["threads"] // 32
    groups = -(-k // kb)
    scores = np.full((B, k, L), -np.inf, F32)
    visits = np.zeros((B, k, L), np.int64)
    stripes = tile // 32
    for b in range(B):
        valid = np.nonzero(mask[b] != -np.inf)[0]
        Lv = int(valid[-1]) + 1 if len(valid) else 0
        for g in range(groups):
            j0 = g * kb
            nb = min(kb, k - j0)
            for t in range(-(-Lv // tile)):
                for w in range(W):
                    for u in range(w, nb * stripes, W):
                        j = u % nb
                        ls = t * tile + (u // nb) * 32 + np.arange(32)
                        ls = ls[ls < Lv]
                        visits[b, j0 + j, ls] += 1
                        keep = ls[mask[b, ls] != -np.inf]
                        acc = np.zeros(len(keep), F32)
                        for i in range(a):
                            th = np.tanh(keys[b, keep, i] + q[b, j0 + j, i])
                            acc = fma(th.astype(F32), v[i], acc)
                        scores[b, j0 + j, keep] = mask[b, keep] + acc
    # the softmax: lane = l % 32 over l < Lv, a butterfly each
    out = np.empty((B, k, L), F32)
    for b in range(B):
        valid = np.nonzero(mask[b] != -np.inf)[0]
        Lv = int(valid[-1]) + 1 if len(valid) else 0
        lanes = -(-max(Lv, 1) // 32) * 32
        s = np.full((k, lanes), -np.inf, F32)
        s[:, :Lv] = scores[b, :, :Lv]
        s = s.reshape(k, -1, 32)                         # [k, rounds, lane]
        with np.errstate(invalid="ignore", over="ignore"):
            m = butterfly(np.fmax.reduce(s, axis=1), np.fmax)
            e = np.exp(s - m[:, None, None]).astype(F32)
            part = np.zeros((k, 32), F32)
            for r in range(e.shape[1]):                  # lane's own order
                part = (part + np.where(
                    np.arange(r * 32, r * 32 + 32) < Lv, e[:, r], 0)
                ).astype(F32)
            total = butterfly(part, np.add)
            x = np.where(np.arange(L) < Lv, scores[b], -np.inf)
            out[b] = (np.exp(x - m[:, None]).astype(F32)
                      / total[:, None]).astype(F32)
    got = torch.from_numpy(out).to(out_dtype)
    return got, visits


def close(got, ref, tol):
    got, ref = got.float(), ref.float()
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    return float((got - ref)[~nan].abs().max()) if (~nan).any() else 0.0


@pytest.mark.parametrize("B,k,L,a", [(1, 1, 1, 8), (3, 4, 7, 8),
                                     (2, 16, 100, 128), (3, 16, 433, 128),
                                     (5, 1, 70, 8), (2, 3, 97, 32)])
def test_model_matches_twin_and_covers_each_frame_once(B, k, L, a):
    (m, q, kk, v), np_in = inputs(B, k, L, a, seed=B * 1000 + k * 100 + L)
    p = ak.plan(B, k, L, a, torch.float32)
    got, visits = k6_model(*np_in, p)
    ref = ak.beam_scores_softmax_plain(m, q, kk, v)
    assert close(got, ref, TOL) <= TOL
    lens = (np_in[0] != -np.inf).sum(1)
    want = (np.arange(L)[None, None] < lens[:, None, None]).astype(np.int64)
    np.testing.assert_array_equal(visits, np.broadcast_to(want, visits.shape))


@pytest.mark.parametrize("plan_of", ["plan", "one_beam_blocks",
                                     "one_block_a_sample"])
def test_model_under_other_plans(plan_of):
    """The scheme's result does not depend on how the beams are grouped
    or how many frames a tile holds."""
    B, k, L, a = 3, 16, 150, 32
    (m, q, kk, v), np_in = inputs(B, k, L, a, seed=7)
    p = ak.plan(B, k, L, a, torch.float32)
    if plan_of == "one_beam_blocks":
        p = {**p, "beams_per_block": 1, "tile": 64, "threads": 64}
    elif plan_of == "one_block_a_sample":
        p = {**p, "beams_per_block": 16, "tile": 32, "threads": 256}
    got, visits = k6_model(*np_in, p)
    assert close(got, ak.beam_scores_softmax_plain(m, q, kk, v), TOL) <= TOL
    assert visits.max() == 1


def test_row_masked_everywhere_is_nan_like_the_twin():
    (m, q, kk, v), np_in = inputs(3, 4, 40, 8, seed=3, lens=[40, 0, 17])
    got, _ = k6_model(*np_in, ak.plan(3, 4, 40, 8, torch.float32))
    ref = ak.beam_scores_softmax_plain(m, q, kk, v)
    assert torch.isnan(ref[1]).all() and torch.isnan(got[1]).all()
    assert close(got, ref, TOL) <= TOL
    assert (got[2, :, 17:] == 0).all()


def test_masked_hole_inside_the_row_adds_nothing():
    (m, q, kk, v), np_in = inputs(2, 4, 50, 8, seed=5, lens=[50, 50])
    m[0, 10:20] = float("-inf")
    np_in[0][0, 10:20] = -np.inf
    got, _ = k6_model(*np_in, ak.plan(2, 4, 50, 8, torch.float32))
    ref = ak.beam_scores_softmax_plain(m, q, kk, v)
    assert close(got, ref, TOL) <= TOL
    assert (got[0, :, 10:20] == 0).all()


@pytest.mark.parametrize("B,k,L,a", [(2, 16, 100, 128), (3, 4, 433, 32)])
def test_model_matches_jax_attend_beam(B, k, L, a):
    rng = np.random.default_rng(B * 10 + L)
    H = 24
    (m, _, kk, _), (mask, _, keys, _) = inputs(B, k, L, a, seed=L)
    hidden = rng.standard_normal((B, k, H)).astype(F32)
    w_hidden = (rng.standard_normal((H, a)) / np.sqrt(H)).astype(F32)
    v = (0.1 * rng.standard_normal(a)).astype(F32)
    values = rng.standard_normal((B, L, 12)).astype(F32)
    jp = {"w_hidden": jnp.asarray(w_hidden), "v": jnp.asarray(v)}
    ctx_j, align_j = jattn.attend_beam(jp, JAttentionConfig(attn_size=a),
                                       jnp.asarray(mask), jnp.asarray(hidden),
                                       jnp.asarray(keys), jnp.asarray(values))
    q = (torch.from_numpy(hidden) @ torch.from_numpy(w_hidden)).numpy()
    got, _ = k6_model(mask, q, keys, v, ak.plan(B, k, L, a, torch.float32))
    assert close(got, torch.from_numpy(np.array(align_j)), TOL) <= TOL
    # and the port's attend_beam (the twin on the CPU) as well
    tp = {"w_hidden": torch.from_numpy(w_hidden), "v": torch.from_numpy(v)}
    ctx_t, align_t = tattn.attend_beam(tp, AttentionConfig(attn_size=a), m,
                                       torch.from_numpy(hidden), kk,
                                       torch.from_numpy(values))
    assert close(align_t, torch.from_numpy(np.array(align_j)), TOL) <= TOL
    assert float((ctx_t - torch.from_numpy(np.array(ctx_j))).abs().max()
                 ) <= 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_model_against_the_twin_in_f32_and_in_bf16(seed):
    """bf16: K6 widens keys, q and v and rounds only align.  So it sits
    within one bf16 rounding of the twin evaluated in float32 on the same
    bf16 inputs, and within TOL_BF16_TWIN of the bf16 twin."""
    B, k, L, a = 2, 16, 166, 128
    (m, q, kk, v), np_in = inputs(B, k, L, a, seed=seed,
                                  dtype=torch.bfloat16)
    got, _ = k6_model(*np_in, ak.plan(B, k, L, a, torch.bfloat16),
                      out_dtype=torch.bfloat16)
    ref32 = ak.beam_scores_softmax_plain(*[t.float() for t in (m, q, kk, v)])
    nan = torch.isnan(ref32)
    assert torch.equal(torch.isnan(got), nan)
    err = (got.float() - ref32)[~nan].abs()
    assert bool((err <= 2 ** -8 * ref32[~nan].abs() + TOL).all())
    ref16 = ak.beam_scores_softmax_plain(m, q, kk, v)
    assert ref16.dtype == torch.bfloat16
    assert close(got, ref16, TOL_BF16_TWIN) <= TOL_BF16_TWIN


# ---- plan ---------------------------------------------------------------
def fixed_smem(p, a, dtype):
    sb = ak.row_stride(a * (2 if dtype == torch.bfloat16 else 4))
    return 2 * p["tile"] * sb + 16 + 4 * a + 4 * p["beams_per_block"] * a


def check_plan(B, k, L, a, dtype):
    p = ak.plan(B, k, L, a, dtype)
    kb = p["beams_per_block"]
    assert 1 <= kb <= k and p["blocks"] == B * -(-k // kb)
    assert p["tile"] % 32 == 0 and 2 * p["tile"] * ak.row_stride(
        a * (2 if dtype == torch.bfloat16 else 4)) <= max(
            ak.TILE_BYTES, 2 * 32 * ak.row_stride(a * 4))
    assert 32 <= p["threads"] <= 256 and p["threads"] % 32 == 0
    # every warp has a stripe of some beam in a full tile
    assert p["threads"] // 32 <= kb * p["tile"] // 32
    fixed = fixed_smem(p, a, dtype)
    assert p["split"] == (fixed + 4 * kb * L > ak.SMEM)
    assert p["smem"] == fixed + (0 if p["split"] else 4 * kb * L)
    assert p["smem"] <= ak.SMEM
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_at_the_cells_shapes(dtype):
    """The offline cells: B=128, k=16, a=128, L up to a 14.5 s wav's 484
    frames.  Beam groups of 4 (512 blocks, two resident an SM), no split."""
    for L in range(1, 700):
        p = check_plan(128, 16, L, 128, dtype)
        assert (p["beams_per_block"], p["blocks"], p["tile"], p["threads"],
                p["split"]) == (4, 512, 64, 256, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 16, 20])
def test_plan_on_the_servers_row_ladder(dtype, k):
    """MicroBatcher's power-of-two ladder up to max_batch 128, wavs up to
    60 s (2,000 frames): never split, the card's SMs twice filled where
    the beams allow."""
    for B in (1, 2, 4, 8, 16, 32, 64, 128):
        for L in (1, 33, 167, 500, 2000):
            p = check_plan(B, k, L, 128, dtype)
            assert not p["split"]
            assert p["blocks"] >= min(2 * ak.SMS, B * k) or \
                p["beams_per_block"] * 2 > k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,k,a", [(1, 1, 8), (3, 4, 8), (128, 16, 128),
                                   (300, 16, 128), (300, 16, 8), (1, 16, 32),
                                   (3, 16, 128), (128, 1, 8), (2, 16, 8)])
def test_plan_splits_exactly_where_the_scores_overflow(dtype, B, k, a):
    p0 = check_plan(B, k, 1, a, dtype)
    kb = p0["beams_per_block"]
    edge = (ak.SMEM - fixed_smem(p0, a, dtype)) // (4 * kb)
    assert not check_plan(B, k, edge, a, dtype)["split"]
    assert check_plan(B, k, edge + 1, a, dtype)["split"]
    if (B, k, a) == (300, 16, 128):      # a block a sample: L ~ 3,000
        assert kb == 16 and edge == (2951 if dtype == torch.float32
                                     else 3207)
    for L in (1, 7, 100, 433, 3100):     # the card tests' lengths
        check_plan(B, k, L, a, dtype)


@pytest.mark.parametrize("a,dtype", [(7, torch.float32), (6, torch.float32),
                                     (4, torch.bfloat16), (0, torch.float32)])
def test_plan_refuses_rows_off_the_16_byte_grain(a, dtype):
    with pytest.raises(ValueError):
        ak.plan(2, 4, 10, a, dtype)
    with pytest.raises(ValueError):
        ak.plan(2, 4, 10, 8, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("a", [6, 100, 128, 4096])
def test_grain_puts_every_width_on_the_16_byte_grain(a, dtype):
    """``grain``, the width the wrapper launches K6 at: the least width at
    or above ``a`` whose key row is whole 16-byte units (a = 100 stays in
    f32 and goes to 104 in bf16; a = 6 goes to 8 in both; a = 128 stays).
    ``plan`` refuses a row off the grain and plans the grain's, except
    where the two key tiles overflow shared memory (a = 4096), where the
    wrapper raises.  The zero columns leave every score as it was."""
    n = 16 // (2 if dtype == torch.bfloat16 else 4)
    ap = ak.grain(a, dtype)
    assert ap % n == 0 and ap - n < a <= ap
    (m, q, kk, v), _ = inputs(2, 4, 9, a, seed=a, dtype=torch.float64)
    pad = lambda t: torch.nn.functional.pad(t, (0, ap - a))
    torch.testing.assert_close(
        ak.beam_scores_softmax_plain(m, pad(q), pad(kk), pad(v)),
        ak.beam_scores_softmax_plain(m, q, kk, v), atol=1e-12, rtol=0)
    for B, k, L in ((128, 16, 300), (1, 1, 7), (300, 4, 3100)):
        if ap != a:
            with pytest.raises(ValueError):
                ak.plan(B, k, L, a, dtype)
        if a < 4096:
            check_plan(B, k, L, ap, dtype)
        else:
            with pytest.raises(ValueError):
                ak.plan(B, k, L, ap, dtype)


# ---- routing ------------------------------------------------------------
def test_attend_beam_routes_one_head_through_the_wrapper(monkeypatch):
    calls = []
    real = ak.beam_scores_softmax

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(ak, "beam_scores_softmax", spy)
    (m, q, kk, v), _ = inputs(2, 4, 30, 8, seed=11)
    rng = np.random.default_rng(0)
    p = {"w_hidden": torch.from_numpy(rng.standard_normal((6, 8)).astype(F32)),
         "v": v}
    hidden = torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(F32))
    values = torch.from_numpy(rng.standard_normal((2, 30, 5)).astype(F32))
    ctx, align = tattn.attend_beam(p, AttentionConfig(attn_size=8), m,
                                   hidden, kk, values)
    assert len(calls) == 1
    # on the CPU exactly today's expression
    want = ak.beam_scores_softmax_plain(m, hidden @ p["w_hidden"], kk, v)
    assert torch.equal(align, want)
    assert torch.equal(ctx, torch.bmm(want, values))


def test_attend_beam_keeps_several_heads_on_the_plain_path(monkeypatch):
    def refuse(*a):
        raise AssertionError("several heads must not reach K6")

    monkeypatch.setattr(ak, "beam_scores_softmax", refuse)
    (m, q, kk, v), _ = inputs(2, 4, 30, 8, seed=12)
    rng = np.random.default_rng(1)
    p = {"w_hidden": torch.from_numpy(rng.standard_normal((6, 8)).astype(F32)),
         "v": v}
    hidden = torch.from_numpy(rng.standard_normal((2, 4, 6)).astype(F32))
    values = torch.from_numpy(rng.standard_normal((2, 30, 4)).astype(F32))
    cfg = AttentionConfig(attn_size=8, heads=2)
    ctx, align = tattn.attend_beam(p, cfg, m, hidden, kk, values)
    assert ctx.shape == (2, 4, 4) and align.shape == (2, 4, 30)
    # each beam's row equals the one-sample read of attend
    for j in range(4):
        c1, a1 = tattn.attend(p, cfg, m, hidden[:, j], kk, values)
        assert torch.allclose(ctx[:, j], c1, atol=1e-6)
        assert torch.allclose(align[:, j], a1[..., 0], atol=1e-6)


def test_wrapper_counts_no_launch_on_the_cpu():
    """On the CPU the twin runs, counted as no launch, also at a width off
    K6's grain."""
    before = ak.launches
    for a in (8, 7):
        (m, q, kk, v), _ = inputs(2, 4, 9, a, seed=13)
        ak.beam_scores_softmax(m, q, kk, v)
    assert ak.launches == before
    with pytest.raises(ValueError):
        ak.beam_scores_softmax(m[:, :5], q, kk, v)
