"""K3 and K4 of this checkout against those of another, on one card.

    python3 chinese_asr_tpu_torch/tools/topk_ab.py OTHER_ROOT

OTHER_ROOT is a checkout of another commit of this repository, such as
the parent commit unpacked with ``git archive`` into an ignored
directory.  The script runs four processes in turn: other, this, this,
other.  Each imports ``chinese_asr_tpu_torch`` from its own checkout,
which builds that checkout's kernels there; holds ``top_k`` and
``top_k_fused`` against their plain twins; and times both at the beam's
stage-1 shapes ([2048, 5004] and [512, 5004], k = 17) as CUDA graphs of
50 calls over inputs cycled past the L2 (``timing.py``).  Only the
wrappers' public calls are used, so any commit with the fused kernel
serves as the other side.

Prints the card's name and power limit, one JSON line a turn, then each
kernel's times in turn order.  Exits 1 if a kernel disagrees with its
twin.
"""

import json
import os
import runpy
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))
ROWS = (2048, 512)            # stage-1 rows at B = 128 and B = 32, bw 16
V, K = 5004, 17
TOL_FUSED = 1e-5              # K4 against its twin, as in chip_smoke.py


def turn(root: str) -> dict:
    import torch
    sys.path.insert(0, root)
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.ops.cuda import topk
    timing = runpy.run_path(os.path.join(HERE, "timing.py"))
    graph_ms, cold_cycle = timing["graph_ms"], timing["cold_cycle"]
    temp = Config().decoder.temperature
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"root": root, "agrees": True}
    for rows in ROWS:
        xs = cold_cycle(lambda: torch.randn(rows, V, device=dev, generator=g),
                        4 * rows * V)
        ls = cold_cycle(lambda: (3 * torch.randn(rows, V, device=dev,
                                                 generator=g),
                                 -20 * torch.rand(rows, 1, device=dev,
                                                  generator=g)),
                        4 * rows * V)
        x, (logit, bias) = xs(), ls()
        exact = all(torch.equal(a, b) for a, b in
                    zip(topk.top_k(x, K), topk.top_k_plain(x, K)))
        got = topk.top_k_fused(logit, bias, K, temp)[0]
        want = topk.top_k_fused_plain(logit, bias, K, temp)[0]
        out["agrees"] &= exact and float((got - want).abs().max()) <= TOL_FUSED
        out[f"topk [{rows},{V}]"] = graph_ms(lambda: topk.top_k(xs(), K))
        out[f"topk_fused [{rows},{V}]"] = graph_ms(
            lambda: topk.top_k_fused(*ls(), K, temp))
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
    for key in turns[0]:
        if key not in ("root", "agrees"):
            print(f"{key} ms, other, this, this, other: "
                  + ", ".join(f"{t[key]:.4f}" for t in turns), flush=True)
    return 0 if all(t["agrees"] for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
