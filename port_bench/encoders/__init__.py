"""The encoder families of the benchmark's configurations.

A family is the module ``port_bench/encoders/<encoder_type in lower
case>.py``, found by name from the configuration's
``encoder.encoder_type`` as ``lib/common.py`` finds configurations.  It
holds all the benchmark knows of that encoder, and gives:

- ``enc_size(cfg)``: the width of the encoder's output, which sizes the
  attention and decoder layouts;
- ``layout(cfg)``: the encoder's tensors in draw order, as ``(path,
  shape, init)``, ``init`` as ``lib/weights.py`` reads it (a normal
  std, ``"zeros"``, ``"ones"`` or ``("forget", H)``);
- ``frames(feature_frames, cfg)``: the encoder's output frames from the
  frames the front end hands it (``roofline/shapes.py``
  ``encoder_frames``), that is its own subsampling;
- ``encode(prec, params, x, lens, cfg)`` -> ``(enc [B, L, enc_size],
  lens, (h, c))``: the plain reference of the encoder, every product
  through ``prec.mm``; ``(h, c)`` is the decoder's initial state, at the
  decoder's width (``reference/las.py`` ``initial_state``); ``cfg`` is
  for what the tensors do not show, such as strides or heads;
- ``flops(cfg, frames)``: the encoder's model FLOPs for one row of
  ``frames`` front-end frames;
- ``tiny(encoder_section)``: the section at the CPU tests' widths.
"""

from __future__ import annotations

import functools
import importlib.util
import os

from port_bench.lib import common


def of(cfg: dict):
    """The family module of configuration ``cfg``."""
    return load(cfg["encoder"]["encoder_type"])


def load(encoder_type: str):
    """The family module of ``encoder_type``; a type with no module stops
    the run, naming the file that is missing."""
    path = os.path.join(common.BENCH, "encoders", encoder_type.lower() + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"no encoder family for encoder_type "
                         f"{encoder_type!r}: {path} is missing")
    return _module(path)


@functools.lru_cache(maxsize=None)
def _module(path: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        "port_bench_encoder_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
