"""K5: the ADPCM wire decode kernel (``csrc/adpcm.cu``) and its plain twin.

The JAX package has no Pallas kernel here: it decodes the 4-bit ADPCM
wire with a ``lax.scan`` of ``ADPCM_K`` steps over all blocks
(``chinese_asr_tpu/audio/features.py`` ``adpcm_decode_flat``).  As eager
torch ops that scan would be some 256 x 12 launches a batch, so the port
decodes with one kernel launch.

Contract: ``buf`` uint8 [nb * (3 + ADPCM_K / 2)], the packed wire of
``nb`` blocks -> float32 [nb * ADPCM_K], each sample ``int16 / 32768``,
bit-exact with the JAX decode.  Wire layout: bytes [0, nb) the initial
predictor's low byte, [nb, 2nb) its high byte (sign-extended from 16
bits), [2nb, 3nb) the initial step index, then the codes as a
[ADPCM_K / 2, nb] byte matrix whose byte (j, b) holds codes 2j (low
nibble) and 2j + 1 (high nibble) of block b.  A CPU tensor takes the
twin; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import observe
from . import build

ADPCM_K = 256            # samples per block (16 ms at 16 kHz)
ADPCM_IDX_MAX = 95       # largest step index

launches = 0             # kernel launches (the twin never counts)
observe.register_counters(__name__, "launches")

_P, _I = ctypes.c_void_p, ctypes.c_int


def adpcm_step(idx):
    """Exact integer step size for index ``idx`` (numpy array or int
    tensor): geometric, 8 .. 30720 over [0, 95]."""
    return (8 + (idx & 7)) << (idx >> 3)


def adpcm_bytes(n_samples: int) -> int:
    """Wire bytes for ``n_samples`` (a multiple of ADPCM_K)."""
    nb = n_samples // ADPCM_K
    return 3 * nb + nb * ADPCM_K // 2


def adpcm_decode_flat_plain(buf, nb: int):
    """The decode as a torch loop over the ADPCM_K in-block steps, all
    blocks at once (the JAX scan's step, int32 throughout)."""
    K = ADPCM_K
    i32 = torch.int32
    lo = buf[:nb].to(i32)
    hi = buf[nb: 2 * nb].to(i32)
    pred = lo | (hi << 8)
    pred = pred - ((pred >> 15) << 16)                   # sign-extend int16
    idx = buf[2 * nb: 3 * nb].to(i32)
    nib = buf[3 * nb: 3 * nb + nb * K // 2].to(i32).reshape(K // 2, nb)
    codes = torch.stack([nib & 15, nib >> 4], dim=1).reshape(K, nb)
    samples = torch.empty((K, nb), dtype=i32, device=buf.device)
    for t in range(K):
        code = codes[t]
        step = adpcm_step(idx)
        mag = code & 7
        dq = ((2 * mag + 1) * step) >> 3
        pred = torch.clamp(pred + torch.where(code >> 3 != 0, -dq, dq),
                           -32768, 32767)
        idx = torch.clamp(idx + torch.where(mag < 4, -1, 2 * (mag - 3)),
                          0, ADPCM_IDX_MAX)
        samples[t] = pred
    return samples.T.reshape(-1).to(torch.float32) * (1.0 / 32768.0)


def adpcm_decode_flat(buf, nb: int):
    """A CPU tensor takes the plain twin; a CUDA tensor launches K5 (one
    launch decodes every block)."""
    if buf.device.type == "cpu":
        return adpcm_decode_flat_plain(buf, nb)
    build.require("buf", buf, torch.uint8, (adpcm_bytes(nb * ADPCM_K),))
    out = torch.empty(nb * ADPCM_K, dtype=torch.float32, device=buf.device)
    if nb == 0:
        return out
    fn = build.kernel("asr_adpcm_decode", [_P, _P, _I, _P])
    rc = fn(buf.data_ptr(), out.data_ptr(), nb,
            torch.cuda.current_stream(buf.device).cuda_stream)
    build.check("asr_adpcm_decode", rc)
    global launches
    launches += 1
    return out
