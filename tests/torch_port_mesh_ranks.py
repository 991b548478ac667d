"""The jobs of tests/test_torch_port_mesh.py, run on every rank of a gloo
group on the CPU (``parallel/launch.py`` spawns the ranks) and, with
``mesh=None``, on one device in the test process: the same code, so the
single-device port is the oracle of its own mesh.  Imports torch and the
port only, as a spawned rank must.

Every input (config JSON, numpy parameters, batches, wavs) is made in the
test process and handed to the job; each job returns numpy results, the
whole batch's on every rank.
"""

import torch

from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch.config import Config
from chinese_asr_tpu_torch.data.dataset import Batch
from chinese_asr_tpu_torch.decode import beam, greedy, lm_fused
from chinese_asr_tpu_torch.lm.device_ngram import DeviceNgramLM
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.parallel import sharding
from chinese_asr_tpu_torch.train import optim
from chinese_asr_tpu_torch.train import step as step_mod


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


def _fields(res) -> dict:
    return {k: _np(v) for k, v in res._asdict().items()}


def _setup(mesh, cfg_json, params_np):
    """(cfg, this rank's params)."""
    cfg = Config.from_json(cfg_json)
    params = las.params_from_numpy(params_np, "cpu")
    if mesh is not None:
        params = sharding.shard_params(params, cfg, mesh)
    return cfg, params


def _rows(mesh, *tensors):
    """This data rank's rows of each (whole-batch) tensor."""
    if mesh is None:
        return tensors
    rows = sharding.row_slice(tensors[0].shape[0], mesh)
    return tuple(t[rows] for t in tensors)


def _flat(params, cfg, mesh) -> dict:
    if mesh is not None:
        params = sharding.unshard_params(params, cfg, mesh)
    return {n: _np(t) for n, t in optim.flatten(params).items()}


# --------------------------------------------------------------------------
# jobs: job(mesh, **kw) -> numpy results
# --------------------------------------------------------------------------
def mesh_info(mesh):
    import torch.distributed as dist
    return dict(shape=tuple(mesh.shape), names=tuple(mesh.mesh_dim_names),
                backend=dist.get_backend(), rank=dist.get_rank(),
                world=dist.get_world_size())


def decode(mesh, cfg_json, params_np, feats, lens, bw):
    """Greedy and the beam (``beam_decode``: every n-best field) on the
    same batch."""
    cfg, params = _setup(mesh, cfg_json, params_np)
    f, l = _rows(mesh, torch.tensor(feats), torch.tensor(lens))
    g = sharding.gather_rows(greedy.greedy_decode(params, cfg, f, l, mesh),
                             mesh)
    b = sharding.gather_rows(beam.beam_decode(params, cfg, bw, f, l,
                                              mesh=mesh), mesh)
    best = beam.beam_decode_best(params, cfg, bw, f, l, mesh)
    return dict(greedy=_fields(g), beam=_fields(b), best=_fields(best))


def train(mesh, cfg_json, params_np, batches, ss_seed=None):
    """``train_step`` over ``batches`` (numpy, whole batch each): per step
    the metrics, then the whole params after the last step."""
    cfg, params = _setup(mesh, cfg_json, params_np)
    tx = optim.make_optimizer(cfg.train)
    state = tx.init(params)
    gen = None if ss_seed is None else torch.Generator().manual_seed(ss_seed)
    metrics = []
    for nb in batches:
        batch = Batch(*map(torch.tensor, nb))
        if mesh is not None:
            batch = sharding.shard_batch(batch, cfg, mesh)
        params, state, m = step_mod.train_step(params, state, cfg, tx, batch,
                                               gen, mesh)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm",
                                                 "accuracy", "num_tokens")})
    flat = _flat(params, cfg, mesh)
    dtypes = sorted({str(t.dtype) for t in las.tree_leaves(params)})
    return dict(metrics=metrics, params=flat, dtypes=dtypes)


def trainer(mesh, cfg_json, params_np, batches, eval_batch, save_dir):
    """``Trainer.fit`` over ``batches`` with an eval batch that does not
    divide the data axis; the checkpoint's path and the transcripts of the
    eval feats by the single-device ``ASR`` loading it (rank 0)."""
    from chinese_asr_tpu_torch.train.trainer import Trainer
    from chinese_asr_tpu_torch.vocab import Vocab

    cfg = Config.from_json(cfg_json).with_("train", save_dir=save_dir)
    vocab = Vocab.build(["abcdefghijklmnopqrstu"],
                        max_num_words=cfg.vocab.max_num_words)
    tr = Trainer(cfg, las.params_from_numpy(params_np, "cpu"), vocab,
                 device="cpu", mesh=mesh)
    tv = tr.fit(lambda: (Batch(*map(torch.tensor, nb)) for nb in batches),
                lambda: [Batch(*map(torch.tensor, eval_batch))],
                max_steps=len(batches))
    path = tr.ckpt.latest_checkpoint()
    return dict(loss=tv.loss, best_wer=tv.best_wer, step=tv.step,
                ckpt=path, params=_flat(tr.params, cfg, mesh))


def asr(mesh, cfg_json, wavs, bw, max_batch=128, lm_path=None,
        lm_mode="second", lm_topn=20, ckpt_path=None, vocab_words=None,
        wav_bucket=800, files=None, wire="flat"):
    """``ASR(mesh=)`` transcripts of ``wavs`` (and of ``files`` through
    ``transcribe_files``); over another wire than "flat" also the features
    each chunk decodes from, the whole chunk's."""
    from chinese_asr_tpu_torch.vocab import Vocab

    cfg = Config.from_json(cfg_json)
    vocab = (Vocab.build([vocab_words], max_num_words=cfg.vocab.max_num_words)
             if vocab_words else None)
    a = tapi.ASR(ckpt_path=ckpt_path, cfg=cfg, bw=bw, vocab=vocab,
                 lm_path=lm_path, lm_mode=lm_mode, lm_topn=lm_topn,
                 wav_bucket=wav_bucket, device="cpu", mesh=mesh, wire=wire)
    feats = []
    if wire != "flat":
        featurize = a._featurize

        def record(up):
            f, lens = featurize(up)
            feats.append(f if sharding.data_size(mesh) == 1 else
                         sharding._all_gather(f, mesh.get_group(0), 0))
            return f, lens

        a._featurize = record
    out = dict(texts=a.transcribe_wavs(wavs, max_batch=max_batch))
    if feats:
        out["feats"] = [_np(f) for f in feats]
    if files:
        out["files"] = a.transcribe_files(files)
    return out


def golden(mesh, cfg_json, ckpt_path, lm_path, vocab_words, files):
    """The golden shard through ``ASR(mesh=)`` in all five modes."""
    modes = dict(greedy=dict(bw=None), beam_bw4=dict(bw=4),
                 lm_second=dict(bw=4, lm_path=lm_path, lm_mode="second"),
                 lm_second_host=dict(bw=4, lm_path=lm_path,
                                     lm_mode="second_host"),
                 lm_first=dict(bw=4, lm_path=lm_path, lm_mode="first",
                               lm_topn=8))
    return {m: asr(mesh, cfg_json, [], ckpt_path=ckpt_path,
                   vocab_words=vocab_words, files=files, wav_bucket=16000,
                   **kw)["files"] for m, kw in modes.items()}


def entries(mesh, cfg_json, ckpt_path, vocab_words, wav_path, long_path,
            manifest, lm_path):
    """The entry points over ``transcribe_wavs`` on the golden model
    (``transcribe_bytes``, ``transcribe_long``) and ``evaluate_manifest``
    in greedy, beam and the device LM modes."""
    from chinese_asr_tpu_torch.evaluate import evaluate_manifest
    from chinese_asr_tpu_torch.vocab import Vocab

    cfg = Config.from_json(cfg_json)
    vocab = Vocab.build([vocab_words], max_num_words=cfg.vocab.max_num_words)
    a = tapi.ASR(ckpt_path=ckpt_path, cfg=cfg, bw=4, vocab=vocab,
                 device="cpu", mesh=mesh)
    with open(wav_path, "rb") as f:
        out = dict(bytes=a.transcribe_bytes(f.read()),
                   long=a.transcribe_long(long_path, chunk_s=4.0))
    for name, kw in (("greedy", {}), ("beam", dict(bw=4)),
                     ("lm_second", dict(bw=4, lm=lm_path)),
                     ("lm_first", dict(bw=4, lm=lm_path, lm_mode="first",
                                       topn=8))):
        r = evaluate_manifest(a.params, cfg, vocab, manifest, verbose=False,
                              mesh=mesh, **kw)
        out["eval_" + name] = (r["cer"], r["n"], r["pred"])
    return out


def fused(mesh, cfg_json, params_np, feats, lens, arpa, vocab_words, bw,
          topn):
    """``lm_fused_decode`` (every n-best field) over an ARPA's tables."""
    from chinese_asr_tpu_torch.vocab import Vocab

    cfg, params = _setup(mesh, cfg_json, params_np)
    dlm = DeviceNgramLM.from_path(arpa, "cpu")
    vocab = Vocab.build([vocab_words], max_num_words=cfg.vocab.max_num_words)
    tok2lm = torch.from_numpy(dlm.token_id_table(vocab)).long()
    f, l = _rows(mesh, torch.tensor(feats), torch.tensor(lens))
    res = lm_fused.lm_fused_decode(params, cfg, bw, f, l, dlm, tok2lm, topn,
                                   mesh)
    return _fields(sharding.gather_rows(res, mesh))


def errors(mesh, cfg_json, params_np):
    """The messages of a vocab that does not divide the model axis and a
    batch that does not divide the data axis."""
    cfg = Config.from_json(cfg_json)
    out = {}
    try:
        sharding.shard_params(las.params_from_numpy(params_np, "cpu"), cfg,
                              mesh)
    except ValueError as e:
        out["vocab"] = str(e)
    B = sharding.data_size(mesh) + 1
    batch = Batch(*(torch.zeros(B, 2) for _ in range(5)))
    try:
        sharding.shard_batch(batch, cfg, mesh)
    except ValueError as e:
        out["batch"] = str(e)
    return out


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))


def suite(dp, mp, jobs):
    """Every job of ``jobs`` (name, kwargs) on a (dp, mp) mesh; their
    results and the collectives they issued."""
    mesh = sharding.make_mesh(
        Config().with_("mesh", data_parallel=dp, model_parallel=mp), "cpu")
    out = {}
    for name, kw in jobs:
        sharding.reset_counts()
        out[name] = globals()[name.split(":")[0]](mesh, **kw)
        out[name + "/collectives"] = dict(sharding.counts)
    return out
