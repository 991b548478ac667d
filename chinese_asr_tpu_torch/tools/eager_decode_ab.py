"""A/B of the port's eager decode loops between two trees of
``chinese_asr_tpu_torch`` on one card: ``beam_decode_best`` (bw 16) and
``greedy_decode`` called by name, as the mesh path and
``Trainer.evaluate`` call them, at the flagship ``Config()`` on 32
synthetic 9-10 s wavs (random weights, seed 0).

Each tree runs in its own process, in the order given (give A B B A so
the host's drift between processes cancels): the walls of each decode
(median of ``--runs``, host clock to a synchronize, the features made
before), the kernels a batch on the card (``torch.profiler``), and a
digest of the tokens, which must agree between the trees.  With
``--mesh`` each tree also runs ``ASR(mesh=)`` as ``chip_smoke.py``
phase 4b does, on a 2 x 2 mesh of four ranks sharing the card (gloo)
and on a 1 x 1 one (NCCL): rank 0's ``transcribe_wavs`` walls of the
same batch, bw 16 and greedy, median of ``--runs`` after one warm-up,
and the transcripts' digest.

    python3 chinese_asr_tpu_torch/tools/eager_decode_ab.py OTHER . . OTHER

where each root holds a ``chinese_asr_tpu_torch`` package (for instance
``git archive <commit> chinese_asr_tpu_torch | tar -x -C .tmp/parent``,
an ignored directory).
Prints one JSON line a process, then a summary line; exits 1 if the
tokens differ between trees.
"""

import argparse
import hashlib
import json
import os
import runpy
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))


MESHES = ((2, 2), (1, 1))       # (data, model) ranks


def _wavs(np):
    synthetic_wavs = runpy.run_path(
        os.path.join(THIS_ROOT, "chip_smoke.py"))["_synthetic_wavs"]
    return synthetic_wavs(np, np.random.default_rng(0), 32, 9.0, 10.0)


def mesh_rank(shape, runs: int) -> dict:
    """One rank of a ``shape`` mesh: ``transcribe_wavs`` walls (rank 0's
    are reported) and the transcripts' digest."""
    import numpy as np
    import torch

    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.parallel import sharding

    cfg = Config().with_("mesh", data_parallel=shape[0],
                         model_parallel=shape[1])
    mesh = sharding.make_mesh(cfg, "cuda")
    wavs = _wavs(np)
    out = {}
    tag = f"mesh{shape[0]}x{shape[1]}"
    for name, bw in ((f"{tag}_beam_bw16", 16), (f"{tag}_greedy", None)):
        asr = ASR(cfg=cfg, seed=0, mesh=mesh, bw=bw)
        texts = asr.transcribe_wavs(wavs)               # warm-up
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            asr.transcribe_wavs(wavs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        out[name] = dict(
            wall_ms=float(np.median(walls)), wall_ms_min=min(walls),
            wall_ms_max=max(walls),
            tokens=hashlib.sha256("\n".join(texts).encode()).hexdigest())
    return out


def worker(root: str, runs: int, mesh: bool) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chinese_asr_tpu_torch.api import ASR
    from chinese_asr_tpu_torch.config import Config
    from chinese_asr_tpu_torch.decode import beam, greedy

    import chinese_asr_tpu_torch as pkg
    assert os.path.dirname(os.path.abspath(pkg.__file__)) == os.path.join(
        os.path.abspath(root), "chinese_asr_tpu_torch"), pkg.__file__
    asr = ASR(bw=16, cfg=Config(), seed=0)
    wavs = _wavs(np)
    feats, lens = asr._featurize(asr._upload(asr._prep(wavs, None)))
    p, cfg = asr.params, asr.cfg
    fns = {"beam_bw16": lambda: beam.beam_decode_best(p, cfg, 16, feats,
                                                      lens).tokens,
           "greedy": lambda: greedy.greedy_decode(p, cfg, feats,
                                                  lens).tokens}
    out = {"root": root}
    for name, fn in fns.items():
        tokens = fn()                                   # warm-up
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        out[name] = dict(
            wall_ms=float(np.median(walls)), wall_ms_min=min(walls),
            wall_ms_max=max(walls), kernels=kernels,
            tokens=hashlib.sha256(tokens.cpu().numpy().tobytes()).hexdigest())
    if mesh:
        from chinese_asr_tpu_torch.parallel import launch
        del asr, feats, lens
        torch.cuda.empty_cache()
        for shape in MESHES:
            out.update(launch.run_ranks(mesh_rank, shape[0] * shape[1],
                                        args=(shape, runs),
                                        device_type="cuda",
                                        timeout_s=600)[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="package roots, in run order")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--mesh", action="store_true",
                    help="also the 2 x 2 mesh's ASR walls")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.runs, args.mesh)),
              flush=True)
        return 0
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(f"card: {gpu[0] if gpu else 'unknown'}", flush=True)
    results = []
    for root in args.roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--runs", str(args.runs), *(["--mesh"] if args.mesh else []),
             root],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    summary = {}
    names = ("beam_bw16", "greedy") + tuple(
        f"mesh{d}x{m}_{n}" for d, m in (MESHES if args.mesh else ())
        for n in ("beam_bw16", "greedy"))
    for name in names:
        by_root = {}
        for r in results:
            by_root.setdefault(r["root"], []).append(r[name]["wall_ms"])
        summary[name] = dict(
            walls_ms=by_root,
            kernels={r["root"]: r[name].get("kernels") for r in results},
            same_tokens=len({r[name]["tokens"] for r in results}) == 1)
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if all(v["same_tokens"] for v in summary.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
