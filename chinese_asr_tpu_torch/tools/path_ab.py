"""The main path's wall time on this checkout against another, on one card.

    python3 chinese_asr_tpu_torch/tools/path_ab.py OTHER_ROOT

OTHER_ROOT is a checkout of another commit of this repository, such as
the parent commit unpacked with ``git archive`` into an ignored
directory.  The script runs four processes in turn: other, this, this,
other.  Each imports ``chinese_asr_tpu_torch`` from its own checkout
(building that checkout's kernels there), builds ``ASR`` at the flagship
``Config()`` with seed-0 random weights on the card, and times, as the
median of 9 warm runs on the host clock with the card synchronised:

* ``beam_bw16``: ``transcribe_wavs`` of 32 synthetic 9-10 s int16 wavs
  (``chip_smoke.py``'s generator, seed 0), bw 16;
* ``greedy``: the same 32 wavs, greedy;
* ``chunked_160``: 160 such wavs at ``max_batch=128`` (a chunk of 128,
  then one of 32), bw 16.

Only ``ASR``'s public calls are used, so any commit of the port serves as
the other side.  Prints the card's name and power limit, one JSON line a
turn, then each run's median walls in turn order.  Exits 1 if the turns'
transcripts differ.
"""

import hashlib
import json
import os
import runpy
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))
RUNS = 9


def turn(root: str) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, root)
    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.config import Config
    synth = runpy.run_path(os.path.join(THIS_ROOT, "chip_smoke.py"))[
        "_synthetic_wavs"]
    rng = np.random.default_rng(0)
    wavs = synth(np, rng, 32, 9.0, 10.0)
    wavs160 = wavs + synth(np, rng, 128, 9.0, 10.0)
    out = {"root": root}
    digest = hashlib.sha256()
    for name, bw, batch, max_batch in (("beam_bw16", 16, wavs, 128),
                                       ("greedy", None, wavs, 128),
                                       ("chunked_160", 16, wavs160, 128)):
        asr = ASR(bw=bw, cfg=Config(), seed=0)
        texts = asr.transcribe_wavs(batch, max_batch=max_batch)
        digest.update("\n".join(texts).encode())
        walls = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            asr.transcribe_wavs(batch, max_batch=max_batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        out[name] = float(np.median(walls))
        out[name + "_range"] = [min(walls), max(walls)]
    out["transcripts_sha256"] = digest.hexdigest()
    return out


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    other = os.path.abspath(argv[0])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, text=True,
                         stdout=subprocess.PIPE).stdout.strip(), flush=True)
    turns = []
    for root in (other, THIS_ROOT, THIS_ROOT, other):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root], check=True, text=True,
                             stdout=subprocess.PIPE)
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    for key in ("beam_bw16", "greedy", "chunked_160"):
        print(f"{key} median wall s, other, this, this, other: "
              + ", ".join(f"{t[key]:.4f}" for t in turns), flush=True)
    same = len({t["transcripts_sha256"] for t in turns}) == 1
    print(f"transcripts equal in all turns: {same}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
