"""Model FLOPs: the matrix products of every layer of the LAS model, for
the work a window completed.

``frames`` is a row's length in the frames the front end hands the
encoder (``shapes.encoder_frames``; its own, not the padded one).  The
encoder is its family's (``port_bench/encoders``: ``flops``, and
``frames`` for the L frames it outputs, ``enc_size`` wide); the
attention keys are one more product (2 L enc_size A).  Decoder, a
hypothesis a step: the cell (2 (E + enc_size) 4Hd + 2 Hd 4Hd), the
attention query (2 Hd A), its scores over the row's L frames (2 L A) and
the context (2 L enc_size), and the output projection (2 (Hd + enc_size)
V).  Training counts the forward three times."""

from __future__ import annotations

from port_bench import encoders


def _dims(cfg: dict):
    dec, att = cfg["decoder"], cfg["attention"]
    return (encoders.of(cfg).enc_size(cfg), dec["hidden_size"],
            dec["embed_dim"], att["attn_size"],
            cfg["vocab"]["max_num_words"] + 4)


def encoder_flops(cfg: dict, frames: int) -> float:
    family = encoders.of(cfg)
    es, Hd, E, A, V = _dims(cfg)
    return family.flops(cfg, frames) \
        + 2 * family.frames(frames, cfg) * es * A


def decoder_step_flops(cfg: dict, frames: int) -> float:
    es, Hd, E, A, V = _dims(cfg)
    L = encoders.of(cfg).frames(frames, cfg)
    return (2 * (E + es) * 4 * Hd + 2 * Hd * 4 * Hd + 2 * Hd * A
            + 2 * L * A + 2 * L * es + 2 * (Hd + es) * V)


def decode_flops(cfg: dict, frames: int, hyps: int, steps: int) -> float:
    """One utterance decoded: its encoder, and ``hyps`` hypotheses for
    ``steps`` steps."""
    return (encoder_flops(cfg, frames)
            + hyps * steps * decoder_step_flops(cfg, frames))


def train_flops(cfg: dict, frames: int, tokens: int) -> float:
    """One utterance of a training step with ``tokens`` target steps."""
    return 3 * (encoder_flops(cfg, frames)
                + tokens * decoder_step_flops(cfg, frames))
