"""audio_s_per_s: the unpadded audio seconds of every utterance the
window's completed calls transcribed, over the window's wall time up to
the end of its last call (host clock)."""


def read(rec):
    w = rec.get("window", {})
    if rec["kind"] != "offline" or "audio_s" not in w:
        return None
    return w["audio_s"] / w["seconds"]
