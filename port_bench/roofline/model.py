"""Model FLOPs: the matrix products of every layer of the LAS model, for
the work a window completed.

Encoder, a row of F frames (its length, not the padded one): each of the
``layers`` layers runs two directions of the input product (2 F D_in 4H)
and the recurrent product (2 F H 4H); the attention keys are one more
product (2 F 2H A).  Decoder, a hypothesis a step: the cell (2 (E + 2H)
4Hd + 2 Hd 4Hd), the attention query (2 Hd A), its scores over the row's
F frames (2 F A) and the context (2 F 2H), and the output projection
(2 (Hd + 2H) V).  Training counts the forward three times."""

from __future__ import annotations


def _dims(cfg: dict):
    enc, dec, att = cfg["encoder"], cfg["decoder"], cfg["attention"]
    D = cfg["audio"]["n_mels"] * 9
    return (D, enc["hidden_size"], enc["num_layers"], dec["hidden_size"],
            dec["embed_dim"], att["attn_size"],
            cfg["vocab"]["max_num_words"] + 4)


def encoder_flops(cfg: dict, frames: int) -> float:
    D, H, layers, Hd, E, A, V = _dims(cfg)
    f = 0.0
    for i in range(layers):
        d_in = D if i == 0 else 2 * H
        f += 2 * (2 * frames * d_in * 4 * H + 2 * frames * H * 4 * H)
    return f + 2 * frames * 2 * H * A


def decoder_step_flops(cfg: dict, frames: int) -> float:
    D, H, layers, Hd, E, A, V = _dims(cfg)
    return (2 * (E + 2 * H) * 4 * Hd + 2 * Hd * 4 * Hd + 2 * Hd * A
            + 2 * frames * A + 2 * frames * 2 * H + 2 * (Hd + 2 * H) * V)


def decode_flops(cfg: dict, frames: int, hyps: int, steps: int) -> float:
    """One utterance decoded: its encoder, and ``hyps`` hypotheses for
    ``steps`` steps."""
    return (encoder_flops(cfg, frames)
            + hyps * steps * decoder_step_flops(cfg, frames))


def train_flops(cfg: dict, frames: int, tokens: int) -> float:
    """One utterance of a training step with ``tokens`` target steps."""
    return 3 * (encoder_flops(cfg, frames)
                + tokens * decoder_step_flops(cfg, frames))
