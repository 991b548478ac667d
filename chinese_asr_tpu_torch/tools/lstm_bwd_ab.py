"""K2-bwd of this checkout against that of another, on one card.

    python3 chinese_asr_tpu_torch/tools/lstm_bwd_ab.py [OTHER_ROOT]

OTHER_ROOT is a checkout of another commit of this repository, such as
the parent commit unpacked with ``git archive`` into an ignored
directory.  The script runs four processes in turn: other, this, this,
other (without OTHER_ROOT, this twice).  Each imports
``chinese_asr_tpu_torch`` from its own checkout, which builds that
checkout's kernels there, holds ``bidir_lstm_time_loop_bwd`` against its
plain twin at the flagship encoder layer's shape (xg 2 x [332, B, 1024],
W_hh [2, 256, 1024]; random non-prefix masks, nonzero final-state
cotangents) and times it by CUDA events at B = 32 and B = 128.  Only the
wrapper's public call is used, so any commit with K2-bwd serves as the
other side.  Both sides take their operands from this checkout's
``chip_smoke.py`` (``lstm_bwd_case``), so they time the same inputs.

Prints the card's name and power limit, one JSON line a turn, then each
time in turn order.  Exits 1 if a kernel disagrees with its twin.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))
T, H = 332, 256
BATCHES = (32, 128)
ITERS = 10


def time_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def turn(root: str) -> dict:
    import torch
    sys.path.insert(0, THIS_ROOT)
    from chip_smoke import TOL_LSTM_BWD, lstm_bwd_case, rel_err
    sys.path.insert(0, root)
    from chinese_asr_tpu_torch.ops.cuda import lstm
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root, "agrees": True}
    g = torch.Generator(device=torch.device("cuda")).manual_seed(7)
    for B in BATCHES:
        args = lstm_bwd_case(torch, lstm, g, T, B, H)
        ref = lstm.bidir_lstm_time_loop_bwd_plain(*args)
        err = rel_err(lstm.bidir_lstm_time_loop_bwd(*args), ref)
        out["agrees"] &= err <= TOL_LSTM_BWD
        out[f"k2_bwd B={B}"] = time_ms(
            torch, lambda: lstm.bidir_lstm_time_loop_bwd(*args))
        del args, ref
    return out


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    other = os.path.abspath(argv[0]) if argv else THIS_ROOT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, text=True,
                         stdout=subprocess.PIPE).stdout.strip(), flush=True)
    turns = []
    for root in (other, THIS_ROOT, THIS_ROOT, other)[:4 if argv else 2]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root], check=True, text=True,
                             stdout=subprocess.PIPE)
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    for key in sorted(set().union(*turns) - {"root", "agrees"}):
        vals = [t[key] for t in turns if key in t]
        if all(isinstance(v, float) for v in vals):
            print(f"{key} ms, in turn order: "
                  + ", ".join(f"{v:.4f}" for v in vals), flush=True)
    return 0 if all(t["agrees"] for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
