"""K8, the Conformer's and the E-Branchformer's subsampling convolutions
(``ops/cuda/subsample.py``, ``csrc/subsample.cu``), and its dispatch in
``ops/conv.py`` ``conv2d_subsampling``.

On the CPU: the plain twin (conv1 in float32, conv2 as three products of
the TF32 words of both operands) against the two ``F.conv2d`` the port
ran before K8, at tiny shapes with odd T and rows of no frames, within
2^-18 of the output's largest value (3xTF32 drops only the lo*lo term,
~2^-22 of a product, and sums in another order); the CPU and autograd
take those two ``F.conv2d`` bit for bit, counted in ``fallbacks``; and
``chip_smoke.py``'s exact launches of the two attention encoders' chunks
are what their encoders call.

Marked ``cuda`` (skipped without a card): K8 against the float64
convolutions of |x|, |w| and |b| at every chunk shape of the offline
cells (128 rows, T2 of 72-316 frames), no farther from them than cuDNN's
float32 pair (TF32 off), one launch a call; exact under a CUDA graph's
replay; within 2^-18 of the twin at small and ragged shapes; and the
inputs it does not take falling back.  Run on a GPU machine with

    python -m pytest tests/test_torch_port_subsample.py -m cuda --noconftest -o addopts=""
"""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from chinese_asr_tpu_torch.config import Config
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.models import conformer as tconf
from chinese_asr_tpu_torch.ops import conv as tconv
from chinese_asr_tpu_torch.ops.cuda import build
from chinese_asr_tpu_torch.ops.cuda import gemm as tgemm
from chinese_asr_tpu_torch.ops.cuda import subsample as tsub
from chinese_asr_tpu_torch.utils import observe

TOL_TWIN = 2 ** -18


def _inputs(B, T, Fq, C, seed=0, lens=None, device="cpu"):
    """x [B, T, Fq] (frames past ``lens`` zeroed), w1, b1, w2, b2 at
    xavier-normal scale."""
    g = torch.Generator().manual_seed(seed)
    x = 3 * torch.randn(B, T, Fq, generator=g)
    if lens is not None:
        x[torch.arange(T)[None] >= torch.tensor(lens)[:, None]] = 0.0
    ops = [x, torch.randn(3, 3, 1, C, generator=g) * (2 / (9 + 9 * C)) ** 0.5,
           0.1 * torch.randn(C, generator=g),
           torch.randn(3, 3, C, C, generator=g) * (1 / (9 * C)) ** 0.5,
           0.1 * torch.randn(C, generator=g)]
    return [t.to(device) for t in ops]


def _two_convs(x, w1, b1, w2, b2):
    """The port's two convolutions before K8, each with its ReLU,
    flattened channel-major."""
    h = F.conv2d(x[:, None], w1.permute(3, 2, 0, 1), b1, stride=2).relu_()
    h = F.conv2d(h, w2.permute(3, 2, 0, 1), b2, stride=2).relu_()
    return h.transpose(1, 2).flatten(2)


def _params(C, d, Fq, seed=1):
    g = torch.Generator().manual_seed(seed)
    _, w1, b1, w2, b2 = _inputs(1, 7, 7, C, seed)
    F2 = tsub.out_size(Fq)
    return {"conv1": {"w": w1, "b": b1}, "conv2": {"w": w2, "b": b2},
            "out": {"w": torch.randn(C * F2, d, generator=g) * 0.05,
                    "b": 0.1 * torch.randn(d, generator=g)}}


@pytest.mark.parametrize("B,T,Fq,C,lens", [
    (3, 29, 80, 32, [29, 0, 13]),
    (2, 7, 7, 32, [7, 0]),
    (4, 42, 23, 64, [42, 41, 8, 0]),
    (1, 61, 80, 160, None)])
def test_plain_twin_agrees_with_the_two_convolutions(B, T, Fq, C, lens):
    ops = _inputs(B, T, Fq, C, seed=T, lens=lens)
    want = _two_convs(*ops)
    got = tsub.convs_plain(*ops)
    assert got.shape == (B, tsub.out_size(T), C * tsub.out_size(Fq))
    assert float((got - want).abs().max()) <= TOL_TWIN * float(
        want.abs().max())


@pytest.mark.parametrize("n", [0, 1, 6, 7, 8, 10, 11, 80, 1268])
def test_out_size_counts_as_the_lengths_do(n):
    assert tsub.out_size(n) == int(tconv.subsample_out_len(torch.tensor(n)))


def _subsampling_before_k8(p, x, lens, slice_elems):
    """``conv2d_subsampling`` as the port ran it before K8."""
    B, T, Fq = x.shape
    w1 = p["conv1"]["w"].permute(3, 2, 0, 1)
    w2 = p["conv2"]["w"].permute(3, 2, 0, 1)
    per_row = w1.shape[0] * ((T - 1) // 2) * ((Fq - 1) // 2)
    rows = max(1, slice_elems // max(1, per_row))
    outs = []
    for s in range(0, B, rows):
        h = F.conv2d(x[s:s + rows, None], w1, p["conv1"]["b"],
                     stride=2).relu_()
        h = F.conv2d(h, w2, p["conv2"]["b"], stride=2).relu_()
        outs.append(h.transpose(1, 2).flatten(2) @ p["out"]["w"]
                    + p["out"]["b"])
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    n = tconv.subsample_out_len(lens)
    return y * (torch.arange(y.shape[1])[None] < n[:, None])[..., None], n


@pytest.mark.parametrize("slice_elems", [tconv.SUBSAMPLE_SLICE_ELEMS, 1])
def test_cpu_takes_the_two_convolutions_bit_for_bit(monkeypatch,
                                                    slice_elems):
    """On the CPU ``conv2d_subsampling`` is the port's path before K8, its
    row slices included, bit for bit: one fallback a call, no launch."""
    monkeypatch.setattr(tconv, "SUBSAMPLE_SLICE_ELEMS", slice_elems)
    p = _params(32, 16, 80)
    lens = torch.tensor([29, 0, 13])
    x = _inputs(3, 29, 80, 32, seed=3, lens=lens.tolist())[0]
    before = tsub.launches, tsub.fallbacks
    y, n = tconv.conv2d_subsampling(p, x, lens)
    assert (tsub.launches - before[0], tsub.fallbacks - before[1]) == (0, 1)
    want, wn = _subsampling_before_k8(p, x, lens, slice_elems)
    assert torch.equal(n, wn)
    assert torch.equal(y, want)


def test_autograd_takes_the_two_convolutions():
    """Under autograd (Conformer training) the subsampling is the two
    ``F.conv2d``, counted as a fallback, and its gradients reach both
    convolutions' weights."""
    p = _params(32, 16, 80)
    for leaf in (p["conv1"]["w"], p["conv2"]["w"]):
        leaf.requires_grad_(True)
    lens = torch.tensor([25, 17])
    x = _inputs(2, 25, 80, 32, seed=4, lens=lens.tolist())[0]
    before = tsub.fallbacks
    y, _ = tconv.conv2d_subsampling(p, x, lens)
    assert tsub.fallbacks - before == 1
    y.square().sum().backward()
    assert float(p["conv1"]["w"].grad.abs().sum()) > 0
    assert float(p["conv2"]["w"].grad.abs().sum()) > 0


def test_takes_refuses_cpu_operands():
    ops = _inputs(2, 29, 80, 32)
    assert not tsub.takes(*ops)
    assert tsub.convs(*ops) is None


def test_weight_split_of_a_convolution_weight_is_its_matrix_split():
    """K8's weight [3, 3, C, C] split by K7's ``weight_split`` as the [9 C,
    C] matrix it is, K-major; cached, and made again after an update in
    place."""
    w = _inputs(1, 7, 7, 32, seed=5)[3]
    hl = tgemm.weight_split(w)
    hi, lo = tgemm.split_tf32(w.reshape(9 * 32, 32).t().contiguous())
    assert torch.equal(hl, torch.stack((hi, lo)))
    assert tgemm.weight_split(w) is hl
    w.mul_(2)
    assert torch.equal(tgemm.weight_split(w)[0], 2 * hi)


@pytest.mark.parametrize("run", chip_smoke.ENCODER_RUNS,
                         ids=[r[0] for r in chip_smoke.ENCODER_RUNS])
def test_smoke_expects_what_the_encoder_launches(run):
    """``chip_smoke.py``'s exact launches of an attention encoder's chunk
    (``_encoder_need``, at the benchmark configuration's depth) are what
    its encoder calls: its blocks, one subsampling, and K7's products
    (each counted here in ``fallbacks``) with the decode's 120."""
    mode, name, blocks, per_block = run
    cfg = chip_smoke._cell_config(Config, name)
    need = chip_smoke._encoder_need(cfg, blocks, per_block)
    narrow = dict(hidden_size=32, self_attn_heads=2, ffn_size=64)
    if cfg.encoder.encoder_type == "E_BRANCHFORMER":
        narrow["cgmlp_size"] = 48
    cfg = cfg.with_("encoder", **narrow)
    params = las.init_params(cfg, 0)
    before = observe.counts()
    lens = torch.tensor([50, 31])
    x = _inputs(2, 50, cfg.audio.n_mels, 32, seed=6, lens=lens.tolist())[0]
    with torch.no_grad():
        las.encode(params, cfg, x, lens)
    ran = observe.count_changes(before)
    assert ran[blocks] == need[blocks] == cfg.encoder.num_layers
    assert ran["subsample.fallbacks"] == need["subsample.launches"] == 1
    assert ran["gemm.fallbacks"] == need["gemm.launches"] - 120


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from chinese_asr_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _f64(x, w1, b1, w2, b2, rows=16):
    x, w1, b1, w2, b2 = (t.double() for t in (x, w1, b1, w2, b2))
    return torch.cat([_two_convs(x[s:s + rows], w1, b1, w2, b2)
                      for s in range(0, x.shape[0], rows)])


# T2 of the offline cells' 8 sorted chunks of 128 rows (the traffic's
# lengths, 4 T2 + 3 to 4 T2 + 6 frames), over 80 log-mels at C = 512
CHUNK_T2 = [72, 84, 95, 105, 117, 132, 155, 316]


@pytest.mark.cuda
@pytest.mark.parametrize("T2", CHUNK_T2)
def test_kernel_within_cudnn_error_at_every_chunk(dev, T2):
    """K8 against the float64 convolutions of |x|, |w| and |b| (relative
    error, all outputs positive): no farther than cuDNN's float32 pair
    (TF32 off), one launch, no fallback."""
    ops = [t.abs() for t in _inputs(128, 4 * T2 + 3 + T2 % 4, 80, 512,
                                    seed=T2, device=dev)]
    with torch.no_grad():
        before = tsub.launches, tsub.fallbacks
        y = tsub.convs(*ops)
        torch.cuda.synchronize()
        assert (tsub.launches - before[0], tsub.fallbacks - before[1]) == (
            1, 0)
        ref = _f64(*ops)
        err = float(((y.double() - ref) / ref).abs().max())
        del y
        lib_err = float(((_two_convs(*ops).double() - ref) / ref).abs().max())
    assert err <= lib_err, (err, lib_err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Fq,C", [(2, 29, 80, 32), (3, 7, 7, 64),
                                      (1, 61, 80, 160), (5, 40, 23, 96),
                                      (130, 11, 80, 512)])
def test_kernel_matches_its_twin_at_ragged_shapes(dev, B, T, Fq, C):
    """Tiles past M and channels past C masked, a single output position,
    several tiles of N: within 2^-18 of the twin's largest value."""
    ops = _inputs(B, T, Fq, C, seed=B + T, device=dev)
    with torch.no_grad():
        got = tsub.convs(*ops)
        want = tsub.convs_plain(*ops)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL_TWIN * float(
        want.abs().max())


@pytest.mark.cuda
def test_kernel_under_a_cuda_graph(dev):
    """A captured launch replays as the eager one, on new inputs copied
    into the captured ones (the weight's cached split made again by
    ``build.refresh`` before the replay, as the program's graph runner
    does), and counts one launch at capture."""
    ops = _inputs(16, 75, 80, 512, seed=7, device=dev)
    new = _inputs(16, 75, 80, 512, seed=8, device=dev)
    with torch.no_grad():
        tsub.convs(*ops)                     # the weight's split cached
        graph = torch.cuda.CUDAGraph()
        before = tsub.launches
        with torch.cuda.graph(graph):
            y = tsub.convs(*ops)
        assert tsub.launches - before == 1
        for t, n in zip(ops, new):
            t.copy_(n)
        build.refresh()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, tsub.convs(*new))


@pytest.mark.cuda
def test_kernel_declines_what_it_does_not_compute(dev):
    """Under autograd, in bfloat16 and at a C off a multiple of 32 the
    subsampling falls back, counted, to the two ``F.conv2d``."""
    ops = _inputs(2, 29, 80, 48, seed=9, device=dev)
    assert not tsub.takes(*ops)
    ops = _inputs(2, 29, 80, 32, seed=9, device=dev)
    assert tsub.takes(*ops)
    assert not tsub.takes(*[t.bfloat16() for t in ops])
    ops[3].requires_grad_(True)
    assert not tsub.takes(*ops)
    before = tsub.fallbacks
    assert tsub.convs(*ops) is None
    assert tsub.fallbacks - before == 1
    with torch.no_grad():
        assert tsub.takes(*ops)


@pytest.mark.cuda
def test_conformer_on_the_card_launches_k8_once(dev):
    """A small Conformer's encoder on the card: one K8 launch for its
    subsampling, no fallback, its output within 1e-4 of the CPU's."""
    from chinese_asr_tpu_torch import config as tcfg
    cfg = tcfg.Config(
        audio=tcfg.AudioConfig(delta_delta=False, downsample=False),
        encoder=tcfg.EncoderConfig(encoder_type="CONFORMER", hidden_size=64,
                                   num_layers=2, ffn_size=128,
                                   self_attn_heads=4, ks=8))
    params = tconf.init_conformer(torch.Generator().manual_seed(0), cfg)
    lens = torch.tensor([90, 61, 17])
    x = _inputs(3, 90, 80, 32, seed=1, lens=lens.tolist())[0]
    want, _ = tconf.apply_conformer(params, cfg, x, lens)

    def on(t):
        if isinstance(t, dict):
            return {k: on(v) for k, v in t.items()}
        return [on(v) for v in t] if isinstance(t, list) else t.to(dev)

    with torch.no_grad():
        before = tsub.launches, tsub.fallbacks
        got, _ = tconf.apply_conformer(on(params), cfg, x.to(dev),
                                       lens.to(dev))
        torch.cuda.synchronize()
        assert (tsub.launches - before[0], tsub.fallbacks - before[1]) == (
            1, 0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
