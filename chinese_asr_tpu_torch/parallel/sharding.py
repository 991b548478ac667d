"""Device-mesh parallelism on torch.distributed (port of
``chinese_asr_tpu/parallel/sharding.py``).

The JAX package states the layout once and lets XLA write the program:
``jax.jit`` with ``NamedSharding``s, the collectives inserted by the SPMD
partitioner.  torch.distributed is multi-controller: one process per rank,
each running the same Python, so every collective is written out here,
named after what it does for the model.  The layout is JAX's:

* a (data, model) mesh, rank ``d * mp + m`` (``make_mesh``);
* data parallel: a batch's rows split over the data axis in order
  (``shard_batch``).  Every rank is handed the whole, globally padded batch
  and keeps its rows; a shard is never re-padded to its own longest row,
  since BatchNorm's statistics include padded positions and K2's T is the
  batch's;
* tensor parallel over the model axis: the decoder's output projection
  ``proj_w`` [H+ctx, V] by columns, ``proj_b`` [V] and the ``embedding``
  [V, E] by rows, V/mp each (``param_pspecs``); everything else is
  replicated, the n-gram LM tables too.

Where XLA inserts a collective at a sharded operand, the port calls one:

* the embedding lookup sums the model ranks' masked rows (``embed``);
* the projection's [R, V/mp] logit slices are all-gathered to full rows
  (``vocab_logits``), as XLA replicates the operand of a Pallas call.  The
  logp transform, K3 / K4 and every argmax then see the single device's
  rows in its column order ("ties to the lower column" holds), and K4's
  logsumexp runs over the whole row;
* each decode loop's early stop is one AND over the whole mesh a step
  (``all_true``), as JAX's ``while_loop`` reads the global batch: a
  beam row whose top beam finished harvests until every row stops, and a
  rank that stopped alone would leave its model-axis peers waiting;
* the winners are all-gathered over the data axis (``gather_rows``);
* in training the loss's token count, BatchNorm's sums and the gradients
  are summed over the data axis (``sum_over_data``,
  ``sum_shares_over_data``, ``sum_grads_over_data``), and the clip's norm
  over the model axis too (``sq_norm``).

Backend: NCCL when every rank has a card of its own, gloo when ranks share
a card (``world_size > torch.cuda.device_count()``) or run on the CPU
(``choose_backend``).  gloo moves CUDA tensors through host memory; the
collectives here stage them there explicitly, bool as uint8 and bf16 / f16
as f32 (exact: the sums that cross the wire in low precision add one
value to zeros, or are BatchNorm's bf16 sums, rounded back once).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# collectives issued by this module since ``reset_counts``: calls, and the
# bytes of the tensors they carry on this rank (an all-reduce's input, an
# all-gather's output)
counts = {"calls": 0, "bytes": 0}

# the vocab-sharded leaves, by name, and the dim that the model axis splits
_VOCAB_DIM = {"proj_w": 1, "proj_b": 0, "embedding": 0}
DEFAULT_TIMEOUT_S = 600.0


def reset_counts() -> None:
    counts.update(calls=0, bytes=0)


# --------------------------------------------------------------------------
# process group and mesh
# --------------------------------------------------------------------------
def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(world_size: int, device_type: str) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU or when
    ranks share a card (NCCL refuses two ranks of one communicator on one
    GPU)."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    if world_size > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(device_type: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Initialise the default process group, unless the caller has: from
    the environment torchrun (or ``launch.run_ranks``) sets (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), else as a world of one on a free
    local port; with ``choose_backend``'s backend and an explicit timeout,
    so a collective that never completes fails instead of hanging.  Rank 0
    prints the choice.  Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    backend = choose_backend(world, device_type)
    if device_type == "cuda" and torch.cuda.is_available():
        # NCCL needs it; under gloo it keeps a bare "cuda" on this rank's card
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    init_method = ("env://" if "MASTER_ADDR" in os.environ
                   else f"tcp://127.0.0.1:{free_port()}")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        if device_type != "cuda" or not torch.cuda.is_available():
            why = "ranks on the CPU"
        elif backend == "gloo":
            why = (f"{world} ranks share {torch.cuda.device_count()} "
                   f"card(s): CUDA tensors cross through host memory")
        else:
            why = "one card a rank"
        print(f"torch.distributed: backend {backend} ({why}), {world} "
              f"rank(s), timeout {timeout_s:.0f} s", flush=True)
    return backend


def make_mesh(cfg, device_type: Optional[str] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S):
    """A ``DeviceMesh`` of shape (dp, mp) with dim names
    ``(cfg.mesh.data_axis, cfg.mesh.model_axis)`` over the default process
    group (initialised here if the caller has not: ``init_distributed``);
    ``data_parallel == -1`` means "all the remaining ranks", so "auto"
    takes the whole world, and a world of one is a 1x1 mesh.  Every axis
    group is made here with the same explicit timeout.  ``device_type``
    ("cuda" or "cpu") picks the backend; default: cuda when present."""
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = init_distributed(device_type, timeout_s)
    n = dist.get_world_size()
    mp = max(1, cfg.mesh.model_parallel)
    dp = cfg.mesh.data_parallel
    if dp == -1:
        dp = n // mp
    if dp < 1 or dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} > {n} devices")
    if dp * mp < n:
        # JAX may leave devices idle; here an idle rank is a process with
        # nothing to do
        raise ValueError(f"mesh {dp}x{mp} uses {dp * mp} of {n} ranks; "
                         f"launch {dp * mp} ranks")
    ranks = np.arange(n).reshape(dp, mp)
    me = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    data_group = model_group = None
    for m in range(mp):                 # every rank creates every group
        g = dist.new_group(ranks[:, m].tolist(), timeout=timeout)
        if me in ranks[:, m]:
            data_group = g
    for d in range(dp):
        g = dist.new_group(ranks[d].tolist(), timeout=timeout)
        if me in ranks[d]:
            model_group = g
    mesh = DeviceMesh.from_group(
        [data_group, model_group], device_type, mesh=torch.as_tensor(ranks),
        mesh_dim_names=(cfg.mesh.data_axis, cfg.mesh.model_axis))
    if me == 0:
        print(f"mesh: {dp} x {mp} ({cfg.mesh.data_axis} x "
              f"{cfg.mesh.model_axis}) over {n} rank(s), {backend}",
              flush=True)
    return mesh


def resolve_mesh(mesh, cfg, device=None):
    """An entry point's ``mesh`` argument: None, a ``DeviceMesh``, or
    "auto" (``make_mesh(cfg)`` over the whole world, its backend chosen
    for ``device``'s type)."""
    if not isinstance(mesh, str):
        return mesh
    if mesh != "auto":
        raise ValueError(f"mesh={mesh!r}: a DeviceMesh or 'auto'")
    return make_mesh(cfg, None if device is None
                     else torch.device(device).type)


def data_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def model_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(1)


def data_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank(0)


# --------------------------------------------------------------------------
# the collectives
# --------------------------------------------------------------------------
def _wire(t, group):
    """The copy of ``t`` that the collective works on in place: on the host
    when gloo carries a CUDA tensor, bool as uint8, bf16 / f16 as f32."""
    dev = t.device
    if t.is_cuda and dist.get_backend(group) == "gloo":
        dev = torch.device("cpu")
    dtype = {torch.bool: torch.uint8, torch.bfloat16: torch.float32,
             torch.float16: torch.float32}.get(t.dtype, t.dtype)
    return t.detach().to(device=dev, dtype=dtype, copy=True).contiguous()


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    w = _wire(t, group)
    dist.all_reduce(w, op=op, group=group)
    counts["calls"] += 1
    counts["bytes"] += w.numel() * w.element_size()
    return w.to(device=t.device, dtype=t.dtype)


def _all_gather(t, group, dim: int):
    w = _wire(t, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    out = torch.cat(parts, dim=dim)
    counts["calls"] += 1
    counts["bytes"] += out.numel() * out.element_size()
    return out.to(device=t.device, dtype=t.dtype)


class _GatherVocab(torch.autograd.Function):
    """All-gather the vocab-sharded last dim.  What follows runs alike on
    every model rank, so the backward keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.n = rank, x.shape[-1]
        return _all_gather(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


class _ToVocabShards(torch.autograd.Function):
    """Identity into a product with vocab-sharded weights; each model rank's
    gradient is a partial sum, so the backward sums them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumVocabShards(torch.autograd.Function):
    """Sum the model ranks' partial values; what follows runs alike on
    every model rank, so the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumDataShares(torch.autograd.Function):
    """Sum over the data axis where each data rank's loss is its share of
    the global loss: the backward sums the shares' gradients too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def vocab_logits(x, w, b, mesh=None):
    """``x @ w + b`` with ``w`` [K, V/mp] and ``b`` [V/mp] this model
    rank's columns: the logits' [..., V/mp] slice all-gathered to full
    [..., V] rows on every model rank.  Without a model axis, the plain
    product."""
    if model_size(mesh) == 1:
        return x @ w + b
    group = mesh.get_group(1)
    y = _ToVocabShards.apply(x, group) @ w + b
    return _GatherVocab.apply(y, group, mesh.get_local_rank(1))


def embed(emb, tok, mesh=None):
    """``emb[tok]`` where ``emb`` is this model rank's V/mp rows: each rank
    gathers the rows it owns, zeros elsewhere, and the model ranks sum.
    One nonzero addend a row, so the sum is exact."""
    if model_size(mesh) == 1:
        return emb[tok]
    rows = emb.shape[0]
    local = tok - mesh.get_local_rank(1) * rows
    own = (local >= 0) & (local < rows)
    x = emb[local.clamp(0, rows - 1)]
    x = torch.where(own[..., None], x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    return _SumVocabShards.apply(x, mesh.get_group(1))


def sum_over_data(t, mesh=None):
    """Sum over the data axis, outside autograd (token counts, metrics)."""
    if data_size(mesh) == 1:
        return t
    return _all_reduce(t, mesh.get_group(0))


def sum_shares_over_data(t, mesh=None):
    """Sum over the data axis through autograd: the backward sums the data
    ranks' gradients (BatchNorm's batch sums in training)."""
    if data_size(mesh) == 1:
        return t
    return _SumDataShares.apply(t, mesh.get_group(0))


def sum_grads_over_data(grads: dict, mesh=None) -> dict:
    """Every gradient summed over the data axis, packed into one float32
    all-reduce.  The loss is the global batch's, so each data rank's
    gradient is its share and the sum is the global gradient; the
    vocab-sharded leaves are summed over the data axis only."""
    if data_size(mesh) == 1:
        return grads
    names = list(grads)
    flat = _all_reduce(torch.cat([grads[n].reshape(-1).float()
                                  for n in names]), mesh.get_group(0))
    out, i = {}, 0
    for n in names:
        k = grads[n].numel()
        out[n] = flat[i:i + k].view_as(grads[n]).to(grads[n].dtype)
        i += k
    return out


def is_vocab_sharded(name: str) -> bool:
    """Is the leaf at path ``name`` ("decoder/proj_w", "mu/decoder/proj_w")
    split over the model axis?"""
    return name.rsplit("/", 1)[-1] in _VOCAB_DIM


def sq_norm(tensors: dict, mesh=None):
    """The sum of squares over every tensor of ``{path: tensor}``: a
    vocab-sharded leaf's share summed over the model axis, a replicated
    leaf counted once."""
    if model_size(mesh) == 1:
        return sum(torch.sum(x * x) for x in tensors.values())
    rep = [x for n, x in tensors.items() if not is_vocab_sharded(n)]
    shard = [x for n, x in tensors.items() if is_vocab_sharded(n)]
    return (sum(torch.sum(x * x) for x in rep)
            + _all_reduce(sum(torch.sum(x * x) for x in shard),
                          mesh.get_group(1)))


def all_true(flag, mesh=None):
    """``flag.all()`` over the whole mesh as a 0-d bool tensor on the
    flag's device: one all-reduce (MIN) over every rank; off a mesh or on
    a 1x1 one, no collective and no host read."""
    if mesh is None or mesh.size() == 1:
        return flag.all()
    x = flag.all().to(torch.int32).reshape(1)
    return _all_reduce(x, dist.group.WORLD, dist.ReduceOp.MIN)[0].to(
        torch.bool)


def gather_rows(result, mesh=None):
    """A NamedTuple of per-row tensors (a decode's result on this rank's
    rows) -> the whole batch's on every rank: each tensor field all-gathered
    over the data axis, in rank order; other fields (``l_final``, a 0-d
    tensor) are the same on every rank."""
    if data_size(mesh) == 1:
        return result
    group = mesh.get_group(0)
    return type(result)(*(_all_gather(f.contiguous(), group, 0)
                          if isinstance(f, torch.Tensor) and f.dim() else f
                          for f in result))


# --------------------------------------------------------------------------
# parameters and batches
# --------------------------------------------------------------------------
def _map_named(fn, tree, name=None):
    """``fn(leaf, name)`` over a parameter tree; ``name`` is the dict key
    above the leaf (None inside a list, as JAX's path names)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v) for v in tree)
    return fn(tree, name)


def param_pspecs(params, cfg):
    """A tree mirroring ``params``: each leaf's spec as JAX's
    ``PartitionSpec`` entries, the model axis's name on the vocab dim of
    ``proj_w`` (columns), ``proj_b`` and ``embedding`` (rows) and None on
    their other dims; ``()`` for a replicated leaf."""
    def spec(leaf, name):
        dim = _VOCAB_DIM.get(name)
        if dim is None:
            return ()
        return tuple(cfg.mesh.model_axis if i == dim else None
                     for i in range(leaf.dim()))

    return _map_named(spec, params)


def _shard_leaf(t, name, mesh):
    dim = _VOCAB_DIM.get(name)
    mp = model_size(mesh)
    if dim is None or mp == 1:
        return t
    V = t.shape[dim]
    if V % mp:
        raise ValueError(f"{name}: its vocab dim ({V}) does not divide the "
                         f"model axis ({mp})")
    n = V // mp
    return t.narrow(dim, mesh.get_local_rank(1) * n, n).clone()


def _unshard_leaf(t, name, mesh):
    dim = _VOCAB_DIM.get(name)
    if dim is None or model_size(mesh) == 1:
        return t
    return _all_gather(t, mesh.get_group(1), dim)


def shard_params(params, cfg, mesh):
    """This rank's parameters: its model rank's V/mp columns of
    ``proj_w``, entries of ``proj_b`` and rows of ``embedding``, every
    other leaf as it is.  A vocab dim that does not divide the model axis
    raises ``ValueError``, as JAX's ``device_put`` refuses it."""
    return _map_named(lambda t, name: _shard_leaf(t, name, mesh), params)


def unshard_params(params, cfg, mesh):
    """The inverse of ``shard_params`` on every rank: the sharded leaves
    all-gathered over the model axis to full tensors."""
    return _map_named(lambda t, name: _unshard_leaf(t, name, mesh), params)


def shard_flat(flat: dict, mesh) -> dict:
    """``shard_params`` for a flat ``{path: tensor}`` dict (an optimizer
    state: ``mu/decoder/proj_w`` is sharded like ``decoder/proj_w``)."""
    return {k: _shard_leaf(v, k.rsplit("/", 1)[-1], mesh)
            for k, v in flat.items()}


def unshard_flat(flat: dict, mesh) -> dict:
    return {k: _unshard_leaf(v, k.rsplit("/", 1)[-1], mesh)
            for k, v in flat.items()}


def _check_rows(B: int, dp: int) -> None:
    if B % dp:
        raise ValueError(
            f"batch size {B} does not divide the data axis ({dp}); for "
            f"mesh training build the loader with drop_last=True "
            f"(data.make_train_loader) or pad the batch to a multiple "
            f"of {dp}")


def row_slice(B: int, mesh) -> slice:
    """This data rank's rows of a global batch of B."""
    dp = data_size(mesh)
    _check_rows(B, dp)
    n = B // dp
    d = data_rank(mesh)
    return slice(d * n, (d + 1) * n)


def pad_shard_rows(mesh, *tensors):
    """This data rank's rows of whole-batch tensors, the batch padded to a
    multiple of the data axis with copies of its last row (a decode's row
    runs alone, and a copy stops when its original does); off a mesh, the
    tensors as they are.  ``trim_rows`` drops the copies again."""
    if data_size(mesh) == 1:
        return tensors
    pad = (-tensors[0].shape[0]) % data_size(mesh)
    if pad:
        tensors = tuple(torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
                        for t in tensors)
    rows = row_slice(tensors[0].shape[0], mesh)
    return tuple(t[rows] for t in tensors)


def trim_rows(result, B: int):
    """A gathered result (NamedTuple) cut back to the batch's first B
    rows."""
    return type(result)(*(f[:B] if isinstance(f, torch.Tensor) and f.dim()
                          else f for f in result))


def shard_batch(batch, cfg, mesh):
    """This data rank's rows of every field of a ``Batch`` (or any
    NamedTuple of per-row tensors) of the global, globally padded batch.
    B % dp != 0 raises ``ValueError`` (JAX's message)."""
    rows = row_slice(batch[0].shape[0], mesh)
    return type(batch)(*(t[rows] for t in batch))
