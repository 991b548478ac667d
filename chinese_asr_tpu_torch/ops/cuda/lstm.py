"""K2: bidirectional LSTM time-loop kernel (``csrc/lstm.cu``) and its
plain twin.

Replaces ``chinese_asr_tpu/ops/pallas/lstm.py`` ``bidir_lstm_time_loop``
(reached through ``ops/rnn.py`` ``_bidir_core_pallas``).  Contract, all
time-major, every operand of one type: xg_f/xg_b [T, B, 4H] (backward
already time-flipped), m_f/m_b [T, B], w_hh [2, H, 4H] -> (ys_f
[T, B, H], ys_b [T, B, H] in the flipped order it was fed, hT [2, B, H],
cT [2, B, H]).

float32 runs the f32 kernel (3xTF32 products, f32 throughout).  bfloat16
(``compute_dtype="bfloat16"``; in JAX the bf16 ``lax.scan``
``_bidir_core_scan``) runs K2-bf16: bf16 x bf16 products accumulated in
f32, the cell update in f32, and y, h and c rounded to bf16 at the end of
each step; the outputs are bf16, as in JAX.

On the card, H alone picks the kernel: H in {64, 128, 192, 256} (the
flagship 256) runs a thread-block-cluster kernel, W_hh resident in
registers and the step's product on the tensor cores; any other H (the
golden model's 16) runs the simple per-block kernel.  B alone picks the
cluster plan (``cluster_shape``): the f32 kernel runs clusters of 8 CTAs
at 16 rows, or 32 from B=113 on; the bf16 one always runs 16 rows, in
clusters of 8 while both directions' fit the card at once (B <= 112),
else of 4, and sends h between its CTAs as bulk copies that complete on
mbarriers.  B <= 224 runs in one wave either way (``csrc/lstm.cu``).

K2-bwd (``csrc/lstm_bwd.cu``) is the recurrence's backward, the VJP
that JAX takes of its ``lax.scan`` (``chinese_asr_tpu/ops/rnn.py``
``_bidir_core_bwd``), and ``bidir_lstm`` the ``torch.autograd.Function``
around K2 that calls it: K2 forward, K2-bwd backward on the card, the two
twins on the CPU.  float32 runs the f32 kernel (3xTF32 products) on K2's
plan: pass 1 (the gates recomputed, c rolled forward) and pass 2 (the
reverse recurrence, dxg_t @ W_hh^T reduce-scattered across the cluster)
in one launch.  bfloat16 (bf16 training, the VJP of JAX's bf16 scan)
runs K2-bwd-bf16: at the cluster kernel's H, pass 1 as three stages,
(a) the rebuild of hs (``rebuild_hs``), (b) hs @ W_hh for all steps as
one f32 batched product (``pre_gates``), (c) the gates' activation and
c's roll (``activate``), then pass 2 on K2-bf16's cluster plan; at other
H the simple kernel.  Its arithmetic: bf16 x bf16 products accumulated in
f32, each step's arithmetic in f32, and bf16 where JAX's VJP carries
bf16: the activated gates it keeps, dxg_t as it is stored, the dh and dc
carries and the rolled-forward c at the end of each step; dW_hh is
accumulated in f32 and rounded to bf16 once.  ``bwd_plan`` shows the
launch of the (serial) cluster kernel.  One call counts one launch of
its kernel's type, however many kernels it runs.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ...utils import observe
from . import build

launches = 0          # f32 kernel launches (the twin never counts)
bf16_launches = 0     # bf16 kernel (K2-bf16) launches
bwd_launches = 0      # K2-bwd launches
bwd_bf16_launches = 0  # K2-bwd-bf16 launches
observe.register_counters(__name__, "launches", "bf16_launches",
                          "bwd_launches", "bwd_bf16_launches")

_P, _I = ctypes.c_void_p, ctypes.c_int

# the hidden sizes of the cluster kernels (csrc/tc.cuh `tc_fits`)
_CLUSTER_H = frozenset((64, 128, 192, 256))
_CLUSTER_BUDGET = 14   # clusters of 8 the card holds at once, less one


def cluster_shape(B: int, H: int, dtype=torch.float32):
    """The cluster kernels' plan rule (``csrc/tc.cuh`` ``tc_mtiles``,
    ``bf16_ctas``), the same for the forward and the backward, without the
    card: batch rows a cluster, CTAs a cluster and clusters in the grid at
    (B, H); None where H takes the simple kernel.  float32 (K2, K2-bwd):
    clusters of 8 CTAs, 16 rows while both directions' clusters fit at
    once, else 32.  bfloat16 (K2-bf16, K2-bwd-bf16's pass 2): always 16
    rows, 8 CTAs while they fit at once, else 4."""
    if H not in _CLUSTER_H:
        return None
    fits = 2 * -(-B // 16) <= _CLUSTER_BUDGET
    if dtype == torch.bfloat16:
        rows, ctas = 16, 8 if fits else 4
    else:
        rows, ctas = 16 if fits else 32, 8
    return dict(rows=rows, ctas=ctas, clusters=2 * -(-B // rows))


def bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w_hh):
    """The recurrence as a Python loop over time (the step formulas of
    ``chinese_asr_tpu/ops/rnn.py`` ``_bidir_core_scan``), computed in
    float32 and rounded to the operands' type where the kernel rounds:
    for bf16, h @ W_hh of bf16 values (each product exact in f32) summed
    in f32, the cell update in f32, then y, h and c rounded to bf16 at the
    end of each step.  For float32 every rounding is a no-op."""
    T, B, H4 = xg_f.shape
    H = H4 // 4
    dt, f32 = xg_f.dtype, torch.float32

    def rnd(x):                        # the carry's precision
        return x.to(dt).to(f32)

    w = w_hh.to(f32)
    z = xg_f.new_zeros((B, H), dtype=f32)
    h = [z, z]
    c = [z, z]
    ys = [xg_f.new_empty((T, B, H)), xg_f.new_empty((T, B, H))]
    xgs, ms = (xg_f, xg_b), (m_f, m_b)
    for t in range(T):
        for d in range(2):
            gates = xgs[d][t].to(f32) + h[d] @ w[d]
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c2 = torch.sigmoid(f) * c[d] + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            m = ms[d][t][:, None].to(f32)
            y = rnd(h2 * m)
            ys[d][t] = y
            h[d] = rnd(y + (1.0 - m) * h[d])
            c[d] = rnd(m * c2 + (1.0 - m) * c[d])
    return ys[0], ys[1], torch.stack(h).to(dt), torch.stack(c).to(dt)


# the C entry point of each operand type, forward and backward
_ENTRY = {torch.float32: "asr_bilstm", torch.bfloat16: "asr_bilstm_bf16"}
_BWD_ENTRY = {torch.float32: "asr_bilstm_bwd",
              torch.bfloat16: "asr_bilstm_bwd_bf16"}


def _plan(name: str, B: int, H: int) -> dict:
    buf = (ctypes.c_int * 4)()
    fn = build.kernel(name, [_I, _I, _P])
    build.check(name, fn(B, H, ctypes.addressof(buf)))
    rows, clusters, resident, ctas = buf
    waves = -(-clusters // resident) if clusters else 0
    return dict(rows=rows, ctas=ctas, clusters=clusters,
                max_active_clusters=resident, waves=waves)


def plan(B: int, H: int, dtype=torch.float32) -> dict:
    """How the kernel launches at (B, H) for operands of ``dtype``,
    without launching: batch rows and CTAs a cluster, clusters in the
    grid, clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``) and the waves that makes
    (``cluster_shape`` is the rule).  The simple kernel (H outside the
    cluster kernel's) has no clusters; its rows are those of a block."""
    return _plan(_ENTRY[dtype] + "_plan", B, H)


def bwd_plan(B: int, H: int, dtype=torch.float32) -> dict:
    """``plan`` for K2-bwd with operands of ``dtype`` (for bfloat16 its
    serial pass 2): rows and CTAs a cluster, clusters, clusters the card
    holds at once and waves of the cluster kernel, or the simple kernel's
    rows a block and no clusters."""
    return _plan(_BWD_ENTRY[dtype] + "_plan", B, H)


def bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w_hh):
    """A CPU tensor takes the plain twin; a CUDA tensor launches the
    kernel of its type, float32 or bfloat16 (one launch runs both
    directions' whole time loop).  Masks of another type are cast to
    xg's."""
    if xg_f.device.type == "cpu":
        return bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w_hh)
    T, B, H4 = xg_f.shape
    H = H4 // 4
    if H4 != 4 * H or H > 1024:
        raise ValueError(f"bidir_lstm_time_loop: hidden size {H4 / 4} "
                         f"unsupported (4H must divide, H <= 1024)")
    dt = xg_f.dtype
    if dt not in _ENTRY:
        raise ValueError(f"bidir_lstm_time_loop: {dt} unsupported "
                         f"(float32 or bfloat16)")
    m_f, m_b = m_f.to(dt), m_b.to(dt)
    build.require("xg_f", xg_f, dt, (T, B, H4))
    build.require("xg_b", xg_b, dt, (T, B, H4))
    build.require("m_f", m_f, dt, (T, B))
    build.require("m_b", m_b, dt, (T, B))
    build.require("w_hh", w_hh, dt, (2, H, H4))
    if dt == torch.bfloat16 and (xg_f.data_ptr() | xg_b.data_ptr()) % 4:
        raise ValueError("bidir_lstm_time_loop: bf16 gates must be 4-byte "
                         "aligned (they are read two units a word)")
    dev = xg_f.device
    ys_f = torch.empty((T, B, H), dtype=dt, device=dev)
    ys_b = torch.empty((T, B, H), dtype=dt, device=dev)
    hT = torch.empty((2, B, H), dtype=dt, device=dev)
    cT = torch.empty((2, B, H), dtype=dt, device=dev)
    if B == 0:
        return ys_f, ys_b, hT, cT
    name = _ENTRY[dt]
    fn = build.kernel(name, [_P] * 9 + [_I] * 3 + [_P])
    rc = fn(xg_f.data_ptr(), xg_b.data_ptr(), m_f.data_ptr(), m_b.data_ptr(),
            w_hh.data_ptr(), ys_f.data_ptr(), ys_b.data_ptr(), hT.data_ptr(),
            cT.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream)
    build.check(name, rc)
    global launches, bf16_launches
    if dt == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return ys_f, ys_b, hT, cT


# --------------------------------------------------------------------------
# K2-bwd: the recurrence's backward
# --------------------------------------------------------------------------
def bidir_lstm_time_loop_bwd_plain(xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b,
                                   gy_f, gy_b, ghT, gcT):
    """The VJP of ``bidir_lstm_time_loop``'s outputs (ys_f, ys_b, hT, cT)
    with respect to xg_f, xg_b and w_hh, given their cotangents gy_f, gy_b
    [T, B, H], ghT, gcT [2, B, H]; the masks get none.  Per direction, as
    K2-bwd computes it:

    1. forward in time: the carried h rebuilt from ys and the masks
       (h_t = y_t + (1 - m_t) h_{t-1}), the gates recomputed from it
       (xg_t + h_{t-1} @ W_hh) and c rolled forward (K2's step formulas);
    2. backward in time from dh = ghT, dc = gcT: dy = gy_t + dh; the
       step's gate cotangents dxg_t; dh <- (1 - m) dh + dxg_t @ W_hh^T,
       dc <- (1 - m) dc + dc2 * f;
    3. dW_hh = sum_t h_{t-1}^T dxg_t, one product.

    Computed in float32 and rounded to the operands' type where K2-bwd
    rounds (for float32 every rounding is a no-op): for bf16 the products
    are of bf16 values (each exact in f32) summed in f32; c is rounded at
    the end of each step of pass 1, as K2-bf16 rounds it; the activated
    gates are kept rounded (the kernel keeps them in dxg's buffer); dxg_t
    is rounded as it is stored and before its product; the dh and dc
    carries are rounded at the end of each step of pass 2; dW_hh is summed
    in f32 and rounded once.  Returns (dxg_f, dxg_b [T, B, 4H], dw_hh
    [2, H, 4H]) in the operands' type."""
    hs, acts, cs = bwd_pass1_plain(xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b)
    return bwd_pass2_plain(m_f, m_b, w_hh, gy_f, gy_b, ghT, gcT, hs, acts,
                           cs)


def _stack(xs, shape, ref):
    """torch.stack(xs), or float32 zeros of ``shape`` where T = 0."""
    return (torch.stack(xs) if xs
            else ref.new_zeros(shape, dtype=torch.float32))


def bwd_pass1_plain(xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b):
    """Pass 1 of ``bidir_lstm_time_loop_bwd_plain``, one loop over time a
    direction: h_{t-1} rebuilt from ys and the masks, the gates
    recomputed from it (xg_t + h_{t-1} @ W_hh, activated, kept rounded)
    and c rolled forward (rounded at the end of each step).  Returns
    float32 hs [2, T, B, H] (h_{t-1}), acts [2, T, B, 4H] (i, f, g, o) and
    cs [2, T, B, H] (c_{t-1}), each value of the operands' precision."""
    T, B, H4 = xg_f.shape
    dt, f32 = xg_f.dtype, torch.float32

    def rnd(x):                        # to the operands' precision
        return x.to(dt).to(f32)

    out = ([], [], [])
    for d, (xg, m, ys) in enumerate(((xg_f, m_f, ys_f), (xg_b, m_b, ys_b))):
        w = w_hh[d].to(f32)
        h = xg.new_zeros((B, H4 // 4), dtype=f32)
        c = xg.new_zeros((B, H4 // 4), dtype=f32)
        hs, cs, acts = [], [], []
        for t in range(T):
            mt = m[t][:, None].to(f32)
            i, f, g, o = torch.chunk(xg[t].to(f32) + h @ w, 4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            hs.append(h)
            cs.append(c)
            acts.append(rnd(torch.cat([i, f, g, o], dim=-1)))
            c = rnd(mt * (f * c + i * g) + (1.0 - mt) * c)
            h = rnd(ys[t].to(f32) + (1.0 - mt) * h)
        for lst, xs, n in zip(out, (hs, acts, cs), (H4 // 4, H4, H4 // 4)):
            lst.append(_stack(xs, (T, B, n), xg))
    return tuple(torch.stack(x) for x in out)


def bwd_pass2_plain(m_f, m_b, w_hh, gy_f, gy_b, ghT, gcT, hs, acts, cs):
    """Pass 2 and dW_hh of ``bidir_lstm_time_loop_bwd_plain`` from pass
    1's hs, acts and cs (float32, [2, T, B, *]): backward in time from
    dh = ghT, dc = gcT, then dW_hh = sum_t h_{t-1}^T dxg_t summed in f32.
    Returns (dxg_f, dxg_b, dw_hh) in the operands' type (gy's)."""
    T, B, H = gy_f.shape
    dt, f32 = gy_f.dtype, torch.float32

    def rnd(x):                        # to the operands' precision
        return x.to(dt).to(f32)

    dxgs, dws = [], []
    for d, (m, gy) in enumerate(((m_f, gy_f), (m_b, gy_b))):
        w = w_hh[d].to(f32)
        dh, dc = ghT[d].to(f32), gcT[d].to(f32)
        dxg = gy.new_empty((T, B, 4 * H), dtype=f32)
        for t in range(T - 1, -1, -1):
            mt = m[t][:, None].to(f32)
            i, f, g, o = torch.chunk(acts[d, t], 4, dim=-1)
            cp = cs[d, t]
            tc = torch.tanh(f * cp + i * g)
            dh2 = (gy[t].to(f32) + dh) * mt
            dc2 = mt * dc + dh2 * o * (1.0 - tc * tc)
            da = rnd(torch.cat([dc2 * g * i * (1.0 - i),
                                dc2 * cp * f * (1.0 - f),
                                dc2 * i * (1.0 - g * g),
                                dh2 * tc * o * (1.0 - o)], dim=-1))
            dxg[t] = da
            dc = rnd((1.0 - mt) * dc + dc2 * f)
            dh = rnd((1.0 - mt) * dh + da @ w.T)
        dxgs.append(dxg.to(dt))
        dws.append(hs[d].reshape(T * B, H).T @ dxg.reshape(T * B, 4 * H))
    return dxgs[0], dxgs[1], torch.stack(dws).to(dt)


# --------------------------------------------------------------------------
# K2-bwd-bf16's pass 1 as three stages (csrc/lstm_bwd.cu): (a) the rebuild
# of hs, (b) pre = hs @ W_hh, f32, (c) the activation and c's roll
# --------------------------------------------------------------------------
def rebuild_hs_plain(ys_f, ys_b, m_f, m_b):
    """Stage (a): hs [2, T, B, H], h_{t-1} of each step rebuilt from ys
    and the masks (h_t = y_t + (1 - m_t) h_{t-1}, rounded to ys's type:
    exact for 0/1 masks, any masks)."""
    T, B, H = ys_f.shape
    dt, f32 = ys_f.dtype, torch.float32
    out = []
    for ys, m in ((ys_f, m_f), (ys_b, m_b)):
        h = ys.new_zeros((B, H), dtype=f32)
        hs = []
        for t in range(T):
            hs.append(h)
            h = (ys[t].to(f32) + (1.0 - m[t][:, None].to(f32)) * h).to(
                dt).to(f32)
        out.append(_stack(hs, (T, B, H), ys))
    return torch.stack(out).to(dt)


def pre_gates(hs, w_hh):
    """Stage (b): hs @ W_hh [2, T, B, 4H], float32 (products of the
    operands' values summed in f32, no rounding after), as one batched
    product; on the card a cuBLAS bmm with an f32 result."""
    _, T, B, H = hs.shape
    if hs.device.type == "cpu":
        pre = torch.bmm(hs.float().view(2, T * B, H), w_hh.float())
    else:
        pre = torch.bmm(hs.view(2, T * B, H), w_hh,
                        out_dtype=torch.float32)
    return pre.view(2, T, B, 4 * H)


def activate_plain(xg_f, xg_b, m_f, m_b, pre):
    """Stage (c): the gates xg_t + pre_t activated (i, f, g, o) and rounded
    to xg's type -> acts [2, T, B, 4H]; c rolled forward under the mask
    (rounded at the end of each step) -> cs [2, T, B, H], c_{t-1}."""
    T, B, H4 = xg_f.shape
    dt, f32 = xg_f.dtype, torch.float32
    acts, cs = [], []
    for d, (xg, m) in enumerate(((xg_f, m_f), (xg_b, m_b))):
        c = xg.new_zeros((B, H4 // 4), dtype=f32)
        a_d, c_d = [], []
        for t in range(T):
            mt = m[t][:, None].to(f32)
            i, f, g, o = torch.chunk(xg[t].to(f32) + pre[d, t], 4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            a_d.append(torch.cat([i, f, g, o], dim=-1))
            c_d.append(c)
            c = (mt * (f * c + i * g) + (1.0 - mt) * c).to(dt).to(f32)
        acts.append(_stack(a_d, (T, B, H4), xg))
        cs.append(_stack(c_d, (T, B, H4 // 4), xg))
    return torch.stack(acts).to(dt), torch.stack(cs).to(dt)


def bwd_pass1_staged_plain(xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b):
    """``bwd_pass1_plain`` as K2-bwd-bf16 computes it, stage by stage:
    (a) ``rebuild_hs_plain``, (b) ``pre_gates``, (c) ``activate_plain``.
    Returns hs, acts, cs in the operands' type."""
    hs = rebuild_hs_plain(ys_f, ys_b, m_f, m_b)
    acts, cs = activate_plain(xg_f, xg_b, m_f, m_b, pre_gates(hs, w_hh))
    return hs, acts, cs


def _stage_ptrs(name, H, operands):
    """The pointers of a stage's operands, each (tensor, dtype, shape),
    checked (``build.require``, 16-byte aligned: a stage reads two units a
    word and f32 pairs, the wrapper's clones keep 16 bytes); the stages
    exist at the cluster kernel's H only."""
    if H not in _CLUSTER_H:
        raise ValueError(f"{name}: H={H} runs the simple kernel, not the "
                         f"stages")
    ptrs = []
    for i, (t, dt, shape) in enumerate(operands):
        build.require(f"{name} operand {i}", t, dt, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operand {i} must be 16-byte aligned")
        ptrs.append(t.data_ptr())
    return ptrs


def rebuild_hs(ys_f, ys_b, m_f, m_b, hs=None):
    """Stage (a) on the card (bf16 at H in {64, 128, 192, 256}), into
    ``hs`` [2, T, B, H] where given; a CPU tensor takes
    ``rebuild_hs_plain``.  Counts no launch: it is a part of K2-bwd-bf16,
    counted once a call by ``bidir_lstm_time_loop_bwd``."""
    if ys_f.device.type == "cpu":
        return rebuild_hs_plain(ys_f, ys_b, m_f, m_b)
    T, B, H = ys_f.shape
    bf = torch.bfloat16
    if hs is None:
        hs = torch.empty((2, T, B, H), dtype=bf, device=ys_f.device)
    name = "asr_bilstm_bwd_bf16_rebuild"
    ptrs = _stage_ptrs(name, H, ((ys_f, bf, (T, B, H)), (ys_b, bf, (T, B, H)),
                                 (m_f, bf, (T, B)), (m_b, bf, (T, B)),
                                 (hs, bf, (2, T, B, H))))
    fn = build.kernel(name, [_P] * 5 + [_I] * 3 + [_P])
    build.check(name, fn(*ptrs, T, B, H,
                         torch.cuda.current_stream(hs.device).cuda_stream))
    return hs


def activate(xg_f, xg_b, m_f, m_b, pre, dxg=None, cs=None):
    """Stage (c) on the card (bf16 at H in {64, 128, 192, 256}), into
    ``dxg`` [2, T, B, 4H] and ``cs`` [2, T, B, H] where given; a CPU tensor
    takes ``activate_plain``.  Counts no launch (see ``rebuild_hs``)."""
    if xg_f.device.type == "cpu":
        return activate_plain(xg_f, xg_b, m_f, m_b, pre)
    T, B, H4 = xg_f.shape
    H, dev, bf = H4 // 4, xg_f.device, torch.bfloat16
    if dxg is None:
        dxg = torch.empty((2, T, B, H4), dtype=bf, device=dev)
    if cs is None:
        cs = torch.empty((2, T, B, H), dtype=bf, device=dev)
    name = "asr_bilstm_bwd_bf16_activate"
    ptrs = _stage_ptrs(name, H, (
        (xg_f, bf, (T, B, H4)), (xg_b, bf, (T, B, H4)), (m_f, bf, (T, B)),
        (m_b, bf, (T, B)), (pre, torch.float32, (2, T, B, H4)),
        (dxg, bf, (2, T, B, H4)), (cs, bf, (2, T, B, H))))
    fn = build.kernel(name, [_P] * 7 + [_I] * 3 + [_P])
    build.check(name, fn(*ptrs, T, B, H,
                         torch.cuda.current_stream(dev).cuda_stream))
    return dxg, cs


def _pass2(args, dxg, cs):
    """K2-bwd-bf16's pass 2 on the card, in place in dxg."""
    m_f, m_b, w_hh = args[2:5]
    gy_f, gy_b, ghT, gcT = args[7:11]
    T, B, H = gy_f.shape
    name = "asr_bilstm_bwd_bf16_pass2"
    fn = build.kernel(name, [_P] * 9 + [_I] * 3 + [_P])
    build.check(name, fn(*(t.data_ptr() for t in (m_f, m_b, w_hh, gy_f,
                                                  gy_b, ghT, gcT, dxg, cs)),
                         T, B, H,
                         torch.cuda.current_stream(dxg.device).cuda_stream))


def _bwd_bf16_staged(args, dxg, hs, cs):
    """K2-bwd-bf16 at H in {64, 128, 192, 256}: stages (a)-(c), pass 2,
    in the order and buffers the wrapper runs them."""
    xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b = args[:7]
    rebuild_hs(ys_f, ys_b, m_f, m_b, hs)
    activate(xg_f, xg_b, m_f, m_b, pre_gates(hs, w_hh), dxg, cs)
    _pass2(args, dxg, cs)


def bwd_bf16_stages(*args, timer):
    """Device ms of each stage of K2-bwd-bf16 (bf16 at H in {64, 128, 192,
    256}) at these operands (``bidir_lstm_time_loop_bwd``'s), by
    ``timer(fn)``: (a) the rebuild, (b) the f32 product, (c) the
    activation, pass 2 (timed with a run of (c) before it, whose time is
    then taken off: pass 2 overwrites (c)'s output) and dW_hh's product."""
    xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b = args[:7]
    T, B, H4 = xg_f.shape
    hs = rebuild_hs(ys_f, ys_b, m_f, m_b)
    pre = pre_gates(hs, w_hh)
    dxg, cs = activate(xg_f, xg_b, m_f, m_b, pre)
    out = dict(rebuild=timer(lambda: rebuild_hs(ys_f, ys_b, m_f, m_b)),
               pre_bmm=timer(lambda: pre_gates(hs, w_hh)),
               activate=timer(lambda: activate(xg_f, xg_b, m_f, m_b, pre,
                                               dxg, cs)))
    both = timer(lambda: (activate(xg_f, xg_b, m_f, m_b, pre, dxg, cs),
                          _pass2(args, dxg, cs)))
    out["pass2"] = both - out["activate"]
    hs_t = hs.view(2, T * B, H4 // 4).transpose(1, 2)
    out["dw_bmm"] = timer(lambda: torch.bmm(
        hs_t, dxg.view(2, T * B, H4), out_dtype=torch.float32).to(
            torch.bfloat16))
    return out


def bidir_lstm_time_loop_bwd(xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, gy_f,
                             gy_b, ghT, gcT):
    """A CPU tensor takes the plain twin; a CUDA tensor runs K2-bwd of its
    type, float32 or bfloat16 (H picks the cluster or the simple kernel;
    bf16 at the cluster kernel's H runs pass 1's stages, then pass 2) and
    forms dW_hh as one batched product of the h sequence with the gate
    cotangents, accumulated in f32.  Every operand but the masks (cast to
    xg's type) must be of xg's type."""
    if xg_f.device.type == "cpu":
        return bidir_lstm_time_loop_bwd_plain(xg_f, xg_b, m_f, m_b, w_hh,
                                              ys_f, ys_b, gy_f, gy_b, ghT,
                                              gcT)
    T, B, H4 = xg_f.shape
    H = H4 // 4
    dt = xg_f.dtype
    if H4 != 4 * H or H > 1024:
        raise ValueError(f"bidir_lstm_time_loop_bwd: hidden size {H4 / 4} "
                         f"unsupported (4H must divide, H <= 1024)")
    if dt not in _BWD_ENTRY:
        raise ValueError(f"bidir_lstm_time_loop_bwd: {dt} unsupported "
                         f"(float32 or bfloat16)")
    ins = dict(xg_f=(xg_f, (T, B, H4)), xg_b=(xg_b, (T, B, H4)),
               m_f=(m_f, (T, B)), m_b=(m_b, (T, B)),
               w_hh=(w_hh, (2, H, H4)), ys_f=(ys_f, (T, B, H)),
               ys_b=(ys_b, (T, B, H)), gy_f=(gy_f, (T, B, H)),
               gy_b=(gy_b, (T, B, H)), ghT=(ghT, (2, B, H)),
               gcT=(gcT, (2, B, H)))
    args = []
    for name, (t, shape) in ins.items():
        mask = name.startswith("m_")
        if t.dtype != dt:
            if not mask:
                raise ValueError(f"bidir_lstm_time_loop_bwd: {name} is "
                                 f"{t.dtype}, xg {dt}")
            t = t.to(dt)
        t = t.contiguous()
        if dt == torch.bfloat16 and not mask and t.data_ptr() % 4:
            raise ValueError(f"bidir_lstm_time_loop_bwd: bf16 {name} must "
                             f"be 4-byte aligned (it is read two units a "
                             f"word)")
        if t.data_ptr() % 16:          # the kernels copy 16-byte chunks
            t = t.clone()
        build.require(name, t, dt, shape)
        args.append(t)
    dev = xg_f.device
    dxg = torch.empty((2, T, B, H4), dtype=dt, device=dev)
    hs = torch.empty((2, T, B, H), dtype=dt, device=dev)
    cs = torch.empty((2, T, B, H), dtype=dt, device=dev)
    if B == 0 or T == 0:
        return dxg[0], dxg[1], torch.zeros_like(w_hh)
    if dt == torch.bfloat16 and H in _CLUSTER_H:
        _bwd_bf16_staged(args, dxg, hs, cs)
    else:
        # W_hh^T [2, 4H, H], read by the simple kernel's pass 2 only (the
        # f32 cluster kernel holds W_hh in registers and ignores it)
        wt = (args[4] if H in _CLUSTER_H
              else args[4].transpose(1, 2).contiguous())
        name = _BWD_ENTRY[dt]
        fn = build.kernel(name, [_P] * 15 + [_I] * 3 + [_P])
        rc = fn(*(a.data_ptr() for a in args[:5]), wt.data_ptr(),
                *(a.data_ptr() for a in args[5:]), dxg.data_ptr(),
                hs.data_ptr(), cs.data_ptr(), T, B, H,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(name, rc)
    global bwd_launches, bwd_bf16_launches
    hs_t = hs.view(2, T * B, H).transpose(1, 2)
    if dt == torch.bfloat16:
        bwd_bf16_launches += 1
        # bf16 products summed in f32, rounded once
        dw = torch.bmm(hs_t, dxg.view(2, T * B, H4),
                       out_dtype=torch.float32).to(dt)
    else:
        bwd_launches += 1
        dw = torch.bmm(hs_t, dxg.view(2, T * B, H4))
    return dxg[0], dxg[1], dw


class _BidirLSTM(torch.autograd.Function):
    """K2 with K2-bwd as its backward (the port of JAX's
    ``_bidir_core_pallas`` custom_vjp), in the operands' type, float32 or
    bfloat16.  The forward keeps xg, the masks, W_hh and ys; the backward
    rebuilds the rest.  Not twice differentiable."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, m_f, m_b, w_hh):
        out = bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w_hh)
        ctx.save_for_backward(xg_f, xg_b, m_f, m_b, w_hh, out[0], out[1])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gy_f, gy_b, ghT, gcT):
        # an output the loss does not reach comes as zeros of its own type
        # (autograd materializes them), so bf16 stays bf16
        xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b = ctx.saved_tensors
        dxg_f, dxg_b, dw = bidir_lstm_time_loop_bwd(
            xg_f, xg_b, m_f, m_b, w_hh, ys_f, ys_b, gy_f, gy_b, ghT, gcT)
        return dxg_f, dxg_b, None, None, dw


def bidir_lstm(xg_f, xg_b, m_f, m_b, w_hh):
    """``bidir_lstm_time_loop`` with a gradient, float32 or bfloat16.
    Under ``torch.no_grad`` (every inference path), or when no operand
    requires a gradient, it is the plain call: one K2 launch on the card,
    nothing saved."""
    if not (torch.is_grad_enabled()
            and (xg_f.requires_grad or xg_b.requires_grad
                 or w_hh.requires_grad)):
        return bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w_hh)
    return _BidirLSTM.apply(xg_f, xg_b, m_f, m_b, w_hh)
