"""The candidate scheme of K3 (exact top-k) and K4 (fused logp + top-k),
``csrc/topk.cu``, modelled in numpy on the CPU and held exactly against
the plain twins and the Pallas kernels (interpret mode).

The model follows the kernel step by step: the columns each thread of a
row scans, batch by batch, as ``plan`` spreads the row over W warps
(float4 ownership where V % 4 == 0, else single columns); the
order-preserving u32 keys; each lane's sorted top-S list with its strict
insertion under the lane's bar (its S-th key, or the warp threshold: the
k-th largest lane head, found by the kernel's bitonic network); the warp
extraction and the merge of the warps' lists; the exhaustion test and the
flat threshold-exclusion fallback; and K4's online (max, sum of exp), its
candidates' keys, their re-sort and its hidden-key test.  K3 is exact;
K4's values agree to the logsumexp's summation order (1e-5), its indices
exactly on separated rows and on rows whose lse is exact.  Inputs are
made with numpy from a seed.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu.ops.pallas import topk as jtopk
from chinese_asr_tpu_torch.ops.cuda import topk as ttopk

from torch_port_util import N, T

S = ttopk.SLOTS
U = 8                        # float4 loads a thread per batch
NE = 4 * U                   # elements a thread per batch
INT_MAX = 2 ** 31 - 1
KEY_INF = 0xFF800000
KEY_TOP = 0xFFFFFFFF
NEG_INF_KEY = 0x007FFFFF     # -inf, held past a row's end
TOL_FUSED = 1e-5


# ---- the kernel's arithmetic ----------------------------------------------
def okey(x):
    """Order-preserving u32 words of f32 values (-0 as +0), as int64."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.int64)
    u = np.where(u == 0x80000000, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def ofloat(key):
    key = np.asarray(key, np.int64)
    u = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def plain_key(x):
    return np.where(np.isnan(x), KEY_INF, okey(x))


def out_value(key):
    return np.where(key == KEY_INF, np.float32(np.nan), ofloat(key))


def rank(key, col):
    """precedes() as one integer: larger key, then lower column."""
    return key.astype(np.uint64) * np.uint64(2 ** 32) + (
        INT_MAX - col).astype(np.uint64)


def warp_kth(v, k):
    """The kernel's bitonic network across each warp's 32 lanes (last
    axis), then lane k - 1's value: the k-th largest."""
    lane = np.arange(32)
    size = 2
    while size <= 32:
        desc = (lane & size) == 0
        stride = size // 2
        while stride:
            o = v[..., lane ^ stride]
            take_max = ((lane & stride) == 0) == desc
            v = np.where(take_max, np.maximum(v, o), np.minimum(v, o))
            stride //= 2
        size *= 2
    return v[..., k - 1]


# Batcher's odd-even merge network for the S = 8 slots, as the kernel's
# sort_list() applies it
NET = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
       (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
       (1, 2), (3, 4), (5, 6)]


def sort_net(ck, cc):
    """Sort the last axis (S slots) by (key descending, column ascending)
    with the kernel's compare-exchange network."""
    ck, cc = ck.copy(), cc.copy()
    for a, b in NET:
        swap = rank(ck[..., b], cc[..., b]) > rank(ck[..., a], cc[..., a])
        ck[..., a], ck[..., b] = (np.where(swap, ck[..., b], ck[..., a]),
                                  np.where(swap, ck[..., a], ck[..., b]))
        cc[..., a], cc[..., b] = (np.where(swap, cc[..., b], cc[..., a]),
                                  np.where(swap, cc[..., a], cc[..., b]))
    return ck, cc


def scan_cols(V, W, vec):
    """[32W, batches, NE]: the column thread t scans as element i of batch
    b (>= V past the row's end, where the kernel holds -inf)."""
    NT = 32 * W
    n = V // 4 if vec else V
    step = (U if vec else NE) * NT
    t = np.arange(NT)[:, None, None]
    b = np.arange(-(-n // step))[None, :, None]
    i = np.arange(NE)[None, None, :]
    q = b * step + ((i // 4) if vec else i) * NT + t
    return 4 * q + i % 4 if vec else q


def lane_bar(last, thr):
    return np.maximum(last, np.where(thr > 0, thr - 1, 0))


def scan(keys, xs, W, vec, k):
    """The one read: per thread its sorted (key, column) list and its
    final bar (no element it dropped has a larger key); with ``xs`` (K4's
    x) also the online (max, sum of exp) and the NaN / +inf flag.  Shapes
    [R, 32W, ...]."""
    R, V = keys.shape
    NT = 32 * W
    cols = scan_cols(V, W, vec)
    ck = np.zeros((R, NT, S), np.int64)
    cc = np.full((R, NT, S), INT_MAX, np.int64)
    thr = np.zeros((R, NT), np.int64)
    bar = np.zeros((R, NT), np.int64)
    m = np.full((R, NT), -np.inf, np.float32)
    s = np.zeros((R, NT), np.float32)
    bad = np.zeros((R, NT), bool)
    nb = cols.shape[1]
    for b in range(nb):
        c = cols[:, b, :]                                    # [NT, NE]
        ok = c < V
        if xs is not None:
            e = np.where(ok, xs[:, np.minimum(c, V - 1)], -np.inf)
            bad |= (~(e < np.inf)).any(-1)                   # [R, NT, NE]
            mn = np.fmax(m, e.max(-1))
            acc = np.zeros((R, NT), np.float32)
            with np.errstate(invalid="ignore", over="ignore"):
                for i in range(NE):
                    term = np.exp(e[..., i] - mn)
                    acc = acc + np.where(e[..., i] != -np.inf, term,
                                         np.float32(0))
                s = np.where(m == mn, s, s * np.exp(m - mn)) + acc
            m = mn
        if k > ttopk.MAX_CAND_K:
            continue                     # no lists: the flat extraction
        if b == 0:
            # the first S elements, sorted, fill the list; then a first
            # threshold
            ck = np.where(ok[:, :S], keys[:, np.minimum(c[:, :S], V - 1)],
                          NEG_INF_KEY)
            cc = np.broadcast_to(c[:, :S], ck.shape)
            ck, cc = sort_net(ck, cc)
            thr = np.repeat(warp_kth(ck[..., 0].reshape(R, W, 32), k), 32,
                            axis=1)
            bar = lane_bar(ck[..., -1], thr)
        for i in range(S if b == 0 else 0, NE):
            key = np.where(ok[:, i], keys[:, np.minimum(c[:, i], V - 1)],
                           NEG_INF_KEY)
            ins = key > bar                                  # [R, NT]
            if not ins.any():
                continue
            col = np.broadcast_to(c[:, i], key.shape)
            for j in range(S - 1, -1, -1):
                here = ins & (key > ck[..., j])
                up = here & (key > ck[..., j - 1]) if j else here & False
                newk = np.where(up, ck[..., j - 1], key) if j else key
                newc = np.where(up, cc[..., j - 1], col) if j else col
                ck[..., j] = np.where(here, newk, ck[..., j])
                cc[..., j] = np.where(here, newc, cc[..., j])
            bar = lane_bar(ck[..., -1], thr)
        if b + 1 < nb:
            thr = np.repeat(warp_kth(ck[..., 0].reshape(R, W, 32), k), 32,
                            axis=1)
            bar = lane_bar(ck[..., -1], thr)
    return ck, cc, bar, (m, s, bad)


def extract(ck, cc, k, W):
    """Each warp's top k by (key, column), the winner's list shifting up,
    then the merge of the W sorted lists: the row's picks [R, k]."""
    R, NT, _ = ck.shape
    ck = ck.reshape(R, W, 32, S).copy()
    cc = cc.reshape(R, W, 32, S).copy()
    pk = np.zeros((R, W, k), np.int64)
    pc = np.zeros((R, W, k), np.int64)
    for j in range(k):
        lane = rank(ck[..., 0], cc[..., 0]).argmax(-1)[..., None]
        bk = np.take_along_axis(ck[..., 0], lane, -1)
        bc = np.take_along_axis(cc[..., 0], lane, -1)
        pk[..., j], pc[..., j] = bk[..., 0], bc[..., 0]
        win = ((ck[..., 0] == bk) & (cc[..., 0] == bc))[..., None]
        ck = np.where(win, np.concatenate([ck[..., 1:], np.zeros_like(
            ck[..., :1])], -1), ck)
        cc = np.where(win, np.concatenate([cc[..., 1:], np.full_like(
            cc[..., :1], INT_MAX)], -1), cc)
    pk, pc = pk.reshape(R, W * k), pc.reshape(R, W * k)
    order = np.lexsort((pc, -pk), axis=1)[:, :k]
    return (np.take_along_axis(pk, order, 1),
            np.take_along_axis(pc, order, 1))


def flat(keys, k):
    """k threshold-exclusion passes over the whole row (`_extract_desc`)."""
    R, V = keys.shape
    col = np.arange(V)[None, :]
    tk = np.full((R, 1), KEY_TOP, np.int64)
    ti = np.full((R, 1), -1, np.int64)
    pk = np.zeros((R, k), np.int64)
    pc = np.zeros((R, k), np.int64)
    for j in range(k):
        taken = (keys > tk) | ((keys == tk) & (col <= ti))
        r = np.where(taken, np.uint64(0), rank(keys, np.broadcast_to(
            col, keys.shape)))
        ti = r.argmax(1)[:, None]
        tk = np.take_along_axis(keys, ti, 1)
        pk[:, j], pc[:, j] = tk[:, 0], ti[:, 0]
    return pk, pc


def candidates_top_k(keys, k, W, vec):
    """K3's scheme on any keys: (picks, rows whose lists ran out)."""
    ck, cc, _, _ = scan(keys, None, W, vec, k)
    pk, pc = extract(ck, cc, k, W)
    last = rank(ck[..., -1], cc[..., -1])
    return pk, pc, (last >= rank(pk[:, -1:], pc[:, -1:])).any(1)


def model_top_k(x, k, W, vec=None):
    """K3 as the kernel computes it: (values, indices, flat rows)."""
    R, V = x.shape
    vec = V % 4 == 0 if vec is None else vec
    keys = plain_key(x)
    if k > ttopk.MAX_CAND_K:
        pk, pc = flat(keys, k)
        return out_value(pk), pc.astype(np.int32), np.zeros(R, bool)
    pk, pc, fall = candidates_top_k(keys, k, W, vec)
    if fall.any():
        pk[fall], pc[fall] = flat(keys[fall], k)
    return out_value(pk), pc.astype(np.int32), fall


def fused_keys(x, lse, b):
    with np.errstate(invalid="ignore", over="ignore"):
        return okey((x - lse) + b)


def model_top_k_fused(logit, bias, k, temp, W, vec=None):
    """K4 as the kernel computes it: (values, indices, flat rows, rows
    read again by their exact keys)."""
    R, V = logit.shape
    vec = V % 4 == 0 if vec is None else vec
    x = (logit.astype(np.float64) * (1.0 / np.float64(temp))).astype(
        np.float32)
    b = bias[:, :1].astype(np.float32)
    ck, cc, bar, (m, s, bad) = scan(okey(x), x, W, vec, k)
    M = np.fmax.reduce(m, axis=1)[:, None]
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        tot = np.where(m == -np.inf, np.float32(0), s * np.exp(m - M))
        lse = M + np.log(tot.sum(1, dtype=np.float32)[:, None])
    poison = bad.any(1) | (M[:, 0] == -np.inf) | np.isnan(b[:, 0]) \
        | (b[:, 0] == np.inf)
    disabled = b[:, 0] == -np.inf
    lse = np.where(poison[:, None] | disabled[:, None], np.float32(0), lse)
    b = np.where(disabled[:, None] | poison[:, None], np.float32(0), b)
    keys = fused_keys(x, lse, b)
    again = np.zeros(R, bool)
    if k > ttopk.MAX_CAND_K:
        pk, pc = flat(keys, k)
        fall = np.zeros(R, bool)
    else:
        # every x a lane dropped is <= its bar
        hid = np.where(bar < okey(np.float32(-np.inf)), 0,
                       fused_keys(ofloat(bar), lse, b))
        ck = np.where(ck != 0, fused_keys(ofloat(ck), lse[..., None],
                                          b[..., None]), 0)
        ck, cc = sort_net(ck, cc)
        pk, pc = extract(ck, cc, k, W)
        again = (hid >= pk[:, -1:]).any(1) & ~poison & ~disabled
        fall = np.zeros(R, bool)
        if again.any():
            with np.errstate(invalid="ignore", over="ignore"):
                score = (x[again] - lse[again]) + b[again]
            qk, qc, f2 = candidates_top_k(plain_key(score), k, W, vec)
            pk[again], pc[again] = qk, qc
            fall[again] = f2
        if fall.any():
            pk[fall], pc[fall] = flat(keys[fall], k)
    vals = out_value(pk)
    idx = pc.astype(np.int32)
    vals[poison], idx[poison] = np.nan, np.arange(k)
    vals[disabled], idx[disabled] = -np.inf, np.arange(k)
    return vals, idx, fall, again


# ---- inputs -----------------------------------------------------------------
def edge_rows(R, V, seed):
    """tests/test_torch_port_topk.py's planted rows, plus signed zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, V)).astype(np.float32)
    x[0, [3, 17, 29, V - 1]] = 7.0              # 4-way tie at the top
    x[1, 11] = np.nan
    x[2, 5] = np.inf
    x[2, 9] = np.nan                            # NaN with +inf
    x[3, :] = -np.inf                           # all -inf (beam step 0)
    x[4, :] = 1.25                              # all tied
    x[5, ::2] = -np.inf
    x[6, :] = np.nan
    x[7, -4:] = 9.0                             # winners in the ragged tail
    x[8] = np.round(x[8])                       # many small-integer ties
    x[9, :] = -0.0
    x[9, ::3] = 0.0                             # -0 ties +0
    return x


def beam_rows(R, V, seed):
    """Stage 1's unfused input: a log-softmax of 3 randn logits plus a
    per-row score, every row but the first of each 16 masked to -inf
    (step 0)."""
    rng = np.random.default_rng(seed)
    lg = torch.from_numpy((3 * rng.standard_normal((R, V))).astype(
        np.float32))
    lp = lg - torch.logsumexp(lg, dim=1, keepdim=True) \
        - torch.from_numpy((20 * rng.random((R, 1))).astype(np.float32))
    lp = lp.numpy()
    lp[np.arange(R) % 16 != 0] = -np.inf
    return lp


def lane0_cols(W, vec, k):
    """k columns that thread 0 of the row scans: all the winners in one
    lane's list."""
    cols = scan_cols(5004, W, vec)[0].ravel()
    return cols[cols < 5004][:k]


def twin(x, k):
    return tuple(N(t) for t in ttopk.top_k_plain(T(x), k))


def assert_exact(got, want):
    np.testing.assert_array_equal(got[0], want[0])      # NaN == NaN
    np.testing.assert_array_equal(got[1], want[1])


def assert_fused_close(got, want, tol=TOL_FUSED):
    gv, gi = got[0], got[1]
    wv, wi = N(want[0]), N(want[1])
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
    np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=tol)
    with np.errstate(invalid="ignore"):
        sep = (np.diff(wv, axis=1) < -tol).all(axis=1) | ~fin.any(axis=1)
    np.testing.assert_array_equal(gi[sep], wi[sep])


# ---- the pieces -------------------------------------------------------------
def test_keys_order_like_floats_and_round_trip():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.integers(
        -30, 30, 500), [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45]]
    ).astype(np.float32)
    kx = okey(x)
    i, j = np.meshgrid(np.arange(len(x)), np.arange(len(x)))
    np.testing.assert_array_equal(kx[i] > kx[j], x[i] > x[j])
    np.testing.assert_array_equal(kx[i] == kx[j], x[i] == x[j])
    back = ofloat(kx)
    np.testing.assert_array_equal(back, np.where(x == 0, 0.0, x))
    assert (kx > 0).all() and okey(np.float32(-np.inf)) == 0x007FFFFF
    assert plain_key(np.float32(np.nan)) == KEY_INF == okey(np.float32(
        np.inf))


def test_sort_network_sorts_any_list():
    """0-1 principle: a compare-exchange network that sorts all 2^8 0-1
    inputs sorts every input; then (key, column) lists with ties."""
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1
    got, _ = sort_net(bits.astype(np.int64), np.zeros((256, 8), np.int64))
    np.testing.assert_array_equal(got, -np.sort(-bits, axis=1))
    rng = np.random.default_rng(4)
    ck = rng.integers(0, 4, (500, 8)).astype(np.int64)
    cc = np.stack([rng.permutation(50)[:8] for _ in range(500)])
    gk, gc = sort_net(ck, cc)
    order = np.lexsort((cc, -ck), axis=-1)
    np.testing.assert_array_equal(gk, np.take_along_axis(ck, order, -1))
    np.testing.assert_array_equal(gc, np.take_along_axis(cc, order, -1))


def test_f64_reciprocal_product_is_the_ieee_divide():
    """K4 computes x = logit / T as the f64 product with rt = 1 / T (f64),
    rounded to f32: bit-equal to the f32 IEEE divide, over normal,
    subnormal, zero, infinite and NaN logits and several T."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32)
    logit = np.concatenate([bits.view(np.float32), np.float32(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3.4e38])])
    temps = [0.7, 1.3, 1.0, 3.0, 1 / 3, 0.1, 2.0 ** -20, 7e5, 1e-40]
    temps += list(rng.uniform(0.05, 5.0, 8))
    with np.errstate(all="ignore"):
        for temp in np.float32(temps):
            want = logit / temp
            got = (logit.astype(np.float64) * (1.0 / np.float64(temp))
                   ).astype(np.float32)
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan)
            np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                          want[~nan].view(np.uint32))


def test_bitonic_network_gives_the_kth_largest():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2 ** 32, (200, 32)).astype(np.int64)
    v[:50, :16] = v[:50, 16:]                   # duplicates
    v[50:60] = 0                                # empty lists
    srt = -np.sort(-v, axis=1)
    for k in (1, 2, 17, 31, 32):
        np.testing.assert_array_equal(warp_kth(v, k), srt[:, k - 1])


def test_plan_fills_the_card_at_the_main_path_shapes():
    p = ttopk.plan(2048, 5004, 17)
    assert (p["warps_per_row"], p["rows_per_block"], p["blocks"]) == (1, 4,
                                                                      512)
    assert p["candidates"] and p["slots"] == S
    p = ttopk.plan(512, 5004, 17)               # B = 32: under one wave
    assert (p["warps_per_row"], p["threads"], p["blocks"]) == (4, 128, 512)
    assert ttopk.plan(1023, 5004, 17)["warps_per_row"] == 4
    assert ttopk.plan(1024, 5004, 17)["warps_per_row"] == 1   # B = 64
    assert ttopk.plan(300, 2047, 17)["warps_per_row"] == 1    # short rows
    assert ttopk.plan(5, 70000, 3)["warps_per_row"] == 4
    assert ttopk.plan(64, 1000, 17)["warps_per_row"] == 1   # short rows
    assert not ttopk.plan(7, 33, 33)["candidates"]


# ---- K3 -----------------------------------------------------------------------
@pytest.mark.parametrize("R,V,k", [(12, 40, 4), (16, 300, 17), (10, 5004, 17),
                                   (10, 5003, 17), (12, 97, 32), (10, 70, 33)])
@pytest.mark.parametrize("W", [1, 4])
def test_k3_scheme_exact_on_edge_rows(R, V, k, W):
    x = edge_rows(R, V, seed=R + V + k)
    got = model_top_k(x, k, W)
    assert_exact(got, twin(x, k))
    assert N(got[1])[3].tolist() == list(range(k))          # all -inf row
    assert N(got[1])[0, :4].tolist() == [3, 17, 29, V - 1]  # lower column


@pytest.mark.parametrize("R,V,k", [(12, 300, 17), (10, 5004, 17)])
def test_k3_scheme_matches_pallas(R, V, k):
    x = edge_rows(R, V, seed=R * V)
    want = jtopk.top_k(jnp.asarray(x), k, interpret=True)
    for W in (1, 4):
        assert_exact(model_top_k(x, k, W), (N(want[0]), N(want[1])))


def test_k3_scheme_scalar_loads_exact():
    """A row that is not 16-byte aligned streams single columns."""
    x = edge_rows(10, 5004, seed=3)
    for W in (1, 4):
        got = model_top_k(x, 17, W, vec=False)
        assert_exact(got, twin(x, 17))


@pytest.mark.parametrize("R_main", [2048, 512])
def test_k3_scheme_beam_rows_never_fall_back(R_main):
    """Beam-like rows, at the warps per row that plan() gives the main
    path's R (B=128 and B=32 at bw 16): exact, and no row falls back."""
    W = ttopk.plan(R_main, 5004, 17)["warps_per_row"]
    x = beam_rows(256, 5004, seed=R_main)
    vals, idx, fall = model_top_k(x, 17, W)
    assert_exact((vals, idx), twin(x, 17))
    assert not fall.any()


@pytest.mark.parametrize("W", [1, 4])
def test_k3_scheme_adversarial_rows_fall_back_exactly(W):
    """All 17 winners in one lane's columns: that lane's list runs out,
    the row takes the flat extraction, and stays exact."""
    rng = np.random.default_rng(W)
    x = rng.standard_normal((6, 5004)).astype(np.float32)
    cols = lane0_cols(W, True, 17)
    x[:, cols] = 10 + rng.random((6, 17)).astype(np.float32)
    x[1, cols] = 10.0                           # and tied
    x[2, cols[:9]] = np.nan                     # and NaN
    vals, idx, fall = model_top_k(x, 17, W)
    assert fall.all()
    assert_exact((vals, idx), twin(x, 17))
    want = jtopk.top_k(jnp.asarray(x), 17, interpret=True)
    assert_exact((vals, idx), (N(want[0]), N(want[1])))


# ---- K4 -----------------------------------------------------------------------
def fused_case(R, V, seed):
    """tests/test_torch_port_topk.py's K4 rows, plus an all -inf row and
    NaN and +inf biases."""
    rng = np.random.default_rng(seed)
    logit = (3 * rng.standard_normal((R, V))).astype(np.float32)
    bias = (-20 * rng.random((R, 1))).astype(np.float32)
    bias[1::4] = -np.inf                        # the beam's step-0 rows
    logit[2, V // 3] = np.nan                   # poisons row 2's lse
    logit[5, 3] = np.nan                        # ...row 5 is -inf anyway
    logit[6, 11] = np.inf                       # lse NaN as well
    logit[7] = np.round(logit[7])               # exact ties
    logit[8, -3:] = 40.0                        # winners in the ragged tail
    logit[10] = -np.inf                         # lse NaN
    bias[11] = np.nan
    bias[12] = np.inf
    return logit, bias


@pytest.mark.parametrize("R,V,k,temp", [(16, 40, 4, 1.0), (16, 300, 17, 0.7),
                                        (16, 5004, 17, 1.0),
                                        (16, 5004, 5, 1.3),
                                        (16, 97, 40, 1.0)])
@pytest.mark.parametrize("W", [1, 4])
def test_k4_scheme_matches_twin(R, V, k, temp, W):
    logit, bias = fused_case(R, V, seed=R * V + k)
    vals, idx, _, _ = model_top_k_fused(logit, bias, k, temp, W)
    assert_fused_close((vals, idx), ttopk.top_k_fused_plain(
        T(logit), T(bias), k, temp))
    assert np.isnan(vals[[2, 6, 10, 11, 12]]).all()
    assert np.isneginf(vals[1::4]).all()
    assert idx[5].tolist() == list(range(k))
    assert idx[8, :3].tolist() == [V - 3, V - 2, V - 1]


def test_k4_scheme_matches_pallas():
    logit, bias = fused_case(16, 5004, seed=11)
    want = jtopk.top_k_fused(jnp.asarray(logit), jnp.asarray(bias), 17, 1.0,
                             interpret=True)
    for W in (1, 4):
        got = model_top_k_fused(logit, bias, 17, 1.0, W)
        assert_fused_close(got[:2], want)


def equal_key_rows(R, V, seed):
    """Rows whose lse is exactly 0 (one logit 0, the rest <= -200, whose
    exp underflows) under a bias of 1e4: key = fl(x + 1e4) merges x that
    lie within one ulp of 1e4, so many keys tie and the lower column must
    win, on the card as in the twin."""
    rng = np.random.default_rng(seed)
    logit = (-201 + rng.random((R, V))).astype(np.float32)
    logit[:, 1234] = 0.0
    return logit, np.full((R, 1), 1e4, np.float32)


@pytest.mark.parametrize("W", [1, 4])
def test_k4_scheme_equal_keys_exact(W):
    logit, bias = equal_key_rows(8, 5004, seed=W)
    want = ttopk.top_k_fused_plain(T(logit), T(bias), 17, 1.0)
    assert len(np.unique(N(want[0])[0])) < 8    # the keys do tie
    got = model_top_k_fused(logit, bias, 17, 1.0, W)[:2]
    assert_exact(got, (N(want[0]), N(want[1])))
    pal = jtopk.top_k_fused(jnp.asarray(logit), jnp.asarray(bias), 17, 1.0,
                            interpret=True)
    assert_exact(got, (N(pal[0]), N(pal[1])))


@pytest.mark.parametrize("W", [1, 4])
def test_k4_scheme_adversarial_and_beam_rows(W):
    """All winners in one lane's columns are read again by their keys,
    then take the flat extraction, and stay within the tolerance;
    beam-like logits never take the flat extraction."""
    rng = np.random.default_rng(5 + W)
    logit = (3 * rng.standard_normal((6, 5004))).astype(np.float32)
    logit[:, lane0_cols(W, True, 17)] = 30 + rng.random((6, 17)).astype(
        np.float32)
    bias = (-20 * rng.random((6, 1))).astype(np.float32)
    vals, idx, fall, again = model_top_k_fused(logit, bias, 17, 1.0, W)
    assert fall.all() and again.all()
    assert_fused_close((vals, idx), ttopk.top_k_fused_plain(
        T(logit), T(bias), 17, 1.0))
    logit = (3 * rng.standard_normal((128, 5004))).astype(np.float32)
    bias = (-20 * rng.random((128, 1))).astype(np.float32)
    bias.reshape(8, 16)[:, 1:] = -np.inf
    vals, idx, fall, again = model_top_k_fused(logit, bias, 17, 1.0, W)
    assert not fall.any() and again.sum() <= 1
    assert_fused_close((vals, idx), ttopk.top_k_fused_plain(
        T(logit), T(bias), 17, 1.0))
