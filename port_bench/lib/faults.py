"""Faults planted under the timed path, for the check that a broken run
comes out not correct (the tests, and ``control.py --fault``, which reads
them at a cell's own size on the card).  Each is a context manager that
patches the program and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def token_altered():
    """The beam's winner with its first token changed, where the winner
    is picked on the device."""
    from chinese_asr_tpu_torch.decode import beam
    real = beam.select_best

    def altered(res, length_weight):
        best = real(res, length_weight)
        tokens = best.tokens.clone()
        tokens[0, 0] = (tokens[0, 0] + 1) % 64
        return best._replace(tokens=tokens)
    return _patched(beam, "select_best", altered)


def answer_altered():
    """Every transcript of a chunk with a character appended, where the
    finalize makes it."""
    from chinese_asr_tpu_torch.api import ASR
    real = ASR._decode_finalize

    def altered(self, res):
        return [t + "<5>" for t in real(self, res)]
    return _patched(ASR, "_decode_finalize", altered)


def topk_shifted():
    """K3 returning each row's ranks 2 .. k + 1 in place of its top k:
    the beam never expands a hypothesis by its best token."""
    from chinese_asr_tpu_torch.ops.cuda import topk
    real = topk.top_k

    def shifted(x, k, fallbacks=None):
        vals, idx = real(x, k + 1, fallbacks)
        return vals[:, 1:].contiguous(), idx[:, 1:].contiguous()
    return _patched(topk, "top_k", shifted)


def second_beam():
    """The winner picked from the beam's hypotheses with the best one
    left out, finished and live alike."""
    import torch
    from chinese_asr_tpu_torch.decode import beam
    real = beam.select_best

    def drop_best(s):
        return s.scatter(1, torch.argmax(s, dim=1, keepdim=True),
                         float("-inf"))

    def second(res, length_weight):
        return real(res._replace(fin_scores=drop_best(res.fin_scores),
                                 live_scores=drop_best(res.live_scores)),
                    length_weight)
    return _patched(beam, "select_best", second)


def state_unchanged():
    """A train step that returns its parameters and optimizer state as it
    got them."""
    from chinese_asr_tpu_torch.train import step
    real = step.train_step

    def unchanged(params, opt_state, *a, **kw):
        _, _, metrics = real(params, opt_state, *a, **kw)
        return params, opt_state, metrics
    return _patched(step, "train_step", unchanged)


def half_batch():
    """A train step over the first half of its batch alone, the mean
    taken over those rows."""
    from chinese_asr_tpu_torch.train import step
    real = step.train_step

    def half(params, opt_state, cfg, tx, batch, *a, **kw):
        n = batch.feats.shape[0] // 2
        return real(params, opt_state, cfg, tx,
                    type(batch)(*(t[:n] for t in batch)), *a, **kw)
    return _patched(step, "train_step", half)


FAULTS = {"token_altered": token_altered, "answer_altered": answer_altered,
          "topk_shifted": topk_shifted, "second_beam": second_beam,
          "state_unchanged": state_unchanged, "half_batch": half_batch}
