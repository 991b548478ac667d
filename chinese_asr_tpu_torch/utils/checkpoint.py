"""Read ``chinese_asr_tpu.v1`` checkpoints (the JAX package's
``utils/checkpoint.py`` format) without JAX.

The payload is a pickle of plain dicts whose parameter leaves are numpy
arrays, so it loads with the standard library; ``models.las
.params_from_numpy`` turns the ``params`` tree into tensors.  Only load
checkpoints you trust: unpickling can run arbitrary code.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict

FORMAT = "chinese_asr_tpu.v1"


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw payload: {"format", "params", "opt_state", "train_var",
    "config_json", "extra"}; ``train_var`` stays a plain dict."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} checkpoint: {path}")
    return payload
