"""Data parallelism across processes: the process group and its
collectives.

Counterpart of the multi-process parts of ``r3det_tpu/parallel/mesh.py``
(``replicate``, ``shard_batch``, the gradient all-reduce XLA inserts) and
of ``jax.distributed.initialize``. A step on R ranks computes the step of
one process on the global batch, the ranks' local batches concatenated in
rank order (``parallel/train.py``); these helpers carry it:

- ``init_distributed``: joins a ``torch.distributed`` process group from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or from explicit arguments (a ``file://`` store in
  tests);
- ``all_reduce_sum``, ``all_reduce_grads``: sums in place, the gradients
  in fixed-size buckets of one flat f32 buffer in parameter order (a
  parameter without a gradient counts as zeros on every rank);
- ``broadcast_state``: rank 0's parameters, buffers and optimizer trace
  to every rank (``replicate`` asks the hosts for equal values; the port
  makes them equal), then ``check_replicas``, which all-gathers a checksum
  of every tensor's bits and raises unless all ranks hold the same;
- ``gather_objects``, ``barrier``.

The backend is explicit and never switches by itself: ``nccl`` on cards,
``gloo`` on the CPU and for ranks that share one card. Over gloo, a CUDA
tensor is reduced through a host copy (gloo reduces host buffers).
Every function takes ``group``, a process group; None means the default
group where one is initialized, and a process alone (rank 0 of 1, every
collective the identity) where none is. A group of one rank still runs
its collectives.
"""
import contextlib
import datetime
import os

import torch
import torch.distributed as dist

# elements of one all-reduce of the flat gradient buffer (64 MiB in f32)
BUCKET_NUMEL = 1 << 24
DEFAULT_TIMEOUT_S = 600


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def init_distributed(backend, init_method=None, world_size=None, rank=None,
                     timeout_s=DEFAULT_TIMEOUT_S):
    """Join the default process group over ``backend`` ('nccl' or 'gloo')
    and return it. ``init_method`` defaults to ``env://`` (torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``); ``world_size`` and ``rank``
    default to ``WORLD_SIZE`` and ``RANK``. Collectives wait at most
    ``timeout_s`` seconds."""
    if backend not in ('nccl', 'gloo'):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    world_size = int(os.environ['WORLD_SIZE'] if world_size is None
                     else world_size)
    rank = int(os.environ['RANK'] if rank is None else rank)
    dist.init_process_group(
        backend, init_method=init_method or 'env://', world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def rank(group=None):
    return dist.get_rank(group) if is_initialized() else 0


def world_size(group=None):
    return dist.get_world_size(group) if is_initialized() else 1


def _through_host(t, group):
    return t.is_cuda and dist.get_backend(group) == 'gloo'


def all_reduce_sum(t, group=None):
    """Sum ``t`` over the ranks of ``group`` in place; returns ``t``."""
    if not is_initialized():
        return t
    if _through_host(t, group):
        host = t.detach().to('cpu')
        dist.all_reduce(host, dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_grads(grads, params, group=None):
    """The gradients ``grads`` (one per parameter of ``params``, None
    where a parameter got none) summed over the ranks of ``group``: f32
    tensors shaped as the parameters, None taken as zeros. The sum runs
    over one flat f32 buffer in parameter order, in buckets of
    BUCKET_NUMEL elements, so every rank receives the same bits."""
    params = list(params)
    flat = torch.cat([(torch.zeros(p.numel(), dtype=torch.float32,
                                   device=p.device) if g is None
                       else g.detach().reshape(-1).float())
                      for g, p in zip(grads, params)])
    for start in range(0, flat.numel(), BUCKET_NUMEL):
        all_reduce_sum(flat[start:start + BUCKET_NUMEL], group)
    return [v.view(p.shape) for v, p in
            zip(flat.split([p.numel() for p in params]), params)]


def barrier(group=None):
    if is_initialized():
        dist.barrier(group=group)


def gather_objects(obj, group=None):
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if not is_initialized():
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def _state_tensors(model, optimizer=None):
    tensors = list(model.state_dict().values())
    if optimizer is not None:
        tensors += list(optimizer.trace)
    return tensors


def broadcast_state(model, optimizer=None, group=None):
    """Rank 0's state dict tensors and, with ``optimizer``, its momentum
    trace and update count, copied in place onto every rank; then
    :func:`check_replicas`."""
    if not is_initialized():
        return
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in _state_tensors(model, optimizer):
            if _through_host(t, group):
                host = t.detach().to('cpu')
                dist.broadcast(host, src, group=group)
                t.copy_(host)
            else:
                dist.broadcast(t, src, group=group)
    if optimizer is not None:
        optimizer.count = gather_objects(optimizer.count, group)[0]
    check_replicas(model, optimizer, group)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def checksum(tensors):
    """(n, 2) int64 checksums of ``tensors``' bits: per tensor the sum of
    its elements read as integers of their width, and the sum of their
    squares (wrapping). Equal tensors give equal rows."""
    rows = []
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        bits = t.view(_BITS[t.element_size()]).to(torch.int64)
        rows.append(torch.stack([bits.sum(), (bits * bits).sum()]))
    if not rows:
        return torch.zeros(0, 2, dtype=torch.int64)
    return torch.stack(rows).cpu()


def check_replicas(model, optimizer=None, group=None):
    """Raise unless every rank of ``group`` holds the same state dict
    (and optimizer trace and count) bit for bit, by an all-gather of
    :func:`checksum`."""
    if not is_initialized():
        return
    mine = (checksum(_state_tensors(model, optimizer)),
            None if optimizer is None else optimizer.count)
    every = gather_objects(mine, group)
    bad = [r for r, (c, n) in enumerate(every)
           if n != every[0][1] or not torch.equal(c, every[0][0])]
    if bad:
        raise RuntimeError(f'ranks {bad} hold another state than rank 0')


def add_launcher_args(parser):
    """The CLIs' process-group arguments."""
    parser.add_argument(
        '--launcher', choices=['none', 'pytorch'], default='none',
        help="'pytorch': join the process group torchrun describes (RANK, "
             'WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)')
    parser.add_argument('--dist-backend', choices=['nccl', 'gloo'],
                        default='nccl',
                        help="'nccl' (default; one rank a card) or 'gloo' "
                             '(the CPU, or ranks sharing a card)')
    parser.add_argument('--dist-url', default=None,
                        help='the group\'s init method (default env://), '
                             'e.g. file:///tmp/store or '
                             'tcp://localhost:29500; without --launcher '
                             'pytorch give --world-size and --rank too')
    parser.add_argument('--world-size', type=int, default=None)
    parser.add_argument('--rank', type=int, default=None)


@contextlib.contextmanager
def launched(args, prog):
    """The CLIs' device and process group from ``args`` (``--device`` and
    :func:`add_launcher_args`'s): yields ``(group, device)``, group None
    when neither ``--launcher pytorch`` nor ``--dist-url`` asks for one,
    and destroys the group at the end. Without a card it raises unless
    given ``--device cpu``. Under a group, a card given without an index
    is the rank's own, ``cuda:LOCAL_RANK``; an explicit index puts the
    rank there (several ranks on one card work over gloo only; NCCL
    refuses them)."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{prog}: no CUDA card; pass --device cpu to run '
                           'on the CPU')
    if args.launcher == 'none' and args.dist_url is None:
        yield None, device
        return
    if args.launcher == 'none' and (args.world_size is None or
                                    args.rank is None):
        raise ValueError('--dist-url without --launcher pytorch needs '
                         '--world-size and --rank')
    rank_ = int(os.environ['RANK'] if args.rank is None else args.rank)
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda',
                                  int(os.environ.get('LOCAL_RANK', rank_)))
        torch.cuda.set_device(device)
    group = init_distributed(args.dist_backend, args.dist_url,
                             args.world_size, rank_)
    try:
        yield group, device
    finally:
        dist.destroy_process_group()
