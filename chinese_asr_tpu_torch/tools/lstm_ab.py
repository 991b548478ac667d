"""K2, K2-bf16, K2-bwd and K2-bwd-bf16 of this checkout against those of
another, on one card.

    python3 chinese_asr_tpu_torch/tools/lstm_ab.py [OTHER_ROOT]

OTHER_ROOT is a checkout of another commit of this repository, such as
the parent commit unpacked with ``git archive`` into an ignored
directory.  The script runs four processes in turn: other, this, this,
other (without OTHER_ROOT, this twice).  Each imports
``chinese_asr_tpu_torch`` from its own checkout, which builds that
checkout's kernels there, holds ``bidir_lstm_time_loop`` and
``bidir_lstm_time_loop_bwd`` against their plain twins at the flagship
encoder layer's shape (xg 2 x [332, B, 1024], W_hh [2, 256, 1024]; random
non-prefix masks, nonzero final-state cotangents), in float32 and in
bfloat16, and times each by CUDA events at B = 32 and B = 128.  Only the
wrappers' public calls are used, so any commit with K2-bwd-bf16 serves as
the other side.  Both sides take their operands from this checkout's
``chip_smoke.py`` (``lstm_bwd_case``, one seed), so they time the same
inputs.

Prints the card's name and power limit, one JSON line a turn, then each
time in turn order with the spread of each side's turns.  Exits 1 if a
kernel disagrees with its twin.
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
    from chip_smoke import (TOL_LSTM, TOL_LSTM_BF16, TOL_LSTM_BWD,
                            TOL_LSTM_BWD_BF16, lstm_bwd_case, rel_err)
    sys.path.insert(0, root)
    from chinese_asr_tpu_torch.ops.cuda import lstm
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root, "agrees": True}
    for B in BATCHES:
        for tag, dt, tol_f, tol_b in (
                ("", None, TOL_LSTM, TOL_LSTM_BWD),
                ("_bf16", torch.bfloat16, TOL_LSTM_BF16, TOL_LSTM_BWD_BF16)):
            g = torch.Generator(device=torch.device("cuda")).manual_seed(7)
            args = lstm_bwd_case(torch, lstm, g, T, B, H, dt)
            fwd = args[:5]
            err_f = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(lstm.bidir_lstm_time_loop(*fwd),
                                        lstm.bidir_lstm_time_loop_plain(*fwd)))
            err_b = rel_err(lstm.bidir_lstm_time_loop_bwd(*args),
                            lstm.bidir_lstm_time_loop_bwd_plain(*args))
            out["agrees"] &= err_f <= tol_f and err_b <= tol_b
            out[f"k2{tag} B={B}"] = time_ms(
                torch, lambda: lstm.bidir_lstm_time_loop(*fwd))
            out[f"k2_bwd{tag} B={B}"] = time_ms(
                torch, lambda: lstm.bidir_lstm_time_loop_bwd(*args))
            del args, fwd
    return out


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(argv[1])), flush=True)
        return 0
    other = os.path.abspath(argv[0]) if argv else THIS_ROOT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, text=True,
                         stdout=subprocess.PIPE).stdout.strip(), flush=True)
    roots = (other, THIS_ROOT, THIS_ROOT, other)[:4 if argv else 2]
    turns = []
    for root in roots:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", root], check=True, text=True,
                             stdout=subprocess.PIPE)
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    for key in sorted(set().union(*turns) - {"root", "agrees"}):
        vals = [t[key] for t in turns]
        line = (f"{key} ms, in turn order: "
                + ", ".join(f"{v:.4f}" for v in vals))
        if argv:
            o = [vals[0], vals[3]]
            t = [vals[1], vals[2]]
            line += (f"; this / other {sum(t) / sum(o):.3f}, spread of "
                     f"the turns: other {abs(o[0] - o[1]):.4f}, this "
                     f"{abs(t[0] - t[1]):.4f}")
        print(line, flush=True)
    return 0 if all(t["agrees"] for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
