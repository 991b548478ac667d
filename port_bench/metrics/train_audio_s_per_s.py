"""train_audio_s_per_s: the unpadded audio seconds of every training step
the window completed, over the window's wall time with the card
synchronised at its end (host clock)."""


def read(rec):
    w = rec.get("window", {})
    if rec["kind"] != "train" or "audio_s" not in w:
        return None
    return w["audio_s"] / w["seconds"]
