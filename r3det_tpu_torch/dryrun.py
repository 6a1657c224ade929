"""Dry-run entry points: a one-card forward check and a data-parallel
train step over several processes on the CPU.

    python -m r3det_tpu_torch.dryrun        # entry() on the card

Port of ``__graft_entry__.py``:

- ``entry(device='cuda')`` returns ``(fn, (images,))``: R3Det R50
  (``R3DET_R50_V1``) in bf16 with seeded weights on a (1, 512, 512, 3)
  zero batch; ``fn`` returns the sum of every ``s0``, ``sr`` and ``rois``
  tensor, so that every head output is computed. ``entry(device,
  'swin')`` builds rotated RetinaNet on Swin-T instead, through the
  config builder from mmdet's model dict (``SWIN_T_RRETINANET``), and
  ``entry(device, 'lsknet')`` on LSKNet-S from mmrotate's
  (``LSKNET_S_RRETINANET``).
- ``dryrun_multichip(n)`` runs one SGD step of JAX's tiny R3Det (depth 10,
  width 32, one stacked conv, one refine stage, 3 classes, 64^2 images,
  the same ``RandomState(0)`` batch of ``n`` images) on ``n`` gloo ranks
  on the CPU (``parallel/dist.py``: each rank its image, gradients summed
  over the ranks), against one process stepping the whole batch. It
  asserts JAX's checks (loss within 1e-5 relative, the updated
  parameters' sums of |p| within 1e-4 relative, a non-zero update on both
  sides) and, since the port can read the parameters, that the ranks hold
  the same parameters bit for bit and that the two updates agree within
  1e-3 of the update's size: a broken gradient collective cannot pass.
  The ranks and the single process are subprocesses on one thread each,
  with ``CUDA_VISIBLE_DEVICES`` empty: the whole run stays on the CPU.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64                   # dryrun_multichip's image side
RANK_TIMEOUT_S = 300        # a rank's process and its group's waits
LOSS_RTOL = 1e-5
PSUM_RTOL = 1e-4
UPDATE_RTOL = 1e-3


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


# mmdet's RetinaNet Swin-T backbone and neck
# (configs/swin/retinanet_swin-t-p4-w7_fpn_1x_coco.py) under the rotated
# RetinaNet head of configs/rretinanet/rretinanet_obb_r50_fpn_1x_dota_v1.py
SWIN_T_RRETINANET = dict(
    type='RotatedRetinaNet',
    backbone=dict(type='SwinTransformer', embed_dims=96, depths=[2, 2, 6, 2],
                  num_heads=[3, 6, 12, 24], window_size=7, mlp_ratio=4,
                  qkv_bias=True, qk_scale=None, drop_rate=0.,
                  attn_drop_rate=0., drop_path_rate=0.2, patch_norm=True,
                  out_indices=(1, 2, 3), with_cp=False,
                  convert_weights=True),
    neck=dict(type='FPN', in_channels=[192, 384, 768], out_channels=256,
              start_level=0, add_extra_convs='on_input', num_outs=5),
    bbox_head=dict(type='RotatedRetinaHead', num_classes=15, in_channels=256,
                   stacked_convs=4, feat_channels=256,
                   bbox_coder=dict(type='DeltaXYWHAOBBoxCoder',
                                   angle_range='v1'),
                   loss_bbox=dict(type='L1Loss', loss_weight=1.0)))


# LSKNet-S as github.com/zcablii/LSKNet's
# configs/lsknet/lsk_s_fpn_1x_dota_le90.py builds it (mlp_ratios the
# class's default) under the same rotated RetinaNet, the FPN on its last
# three stages
LSKNET_S_RRETINANET = dict(
    SWIN_T_RRETINANET,
    backbone=dict(type='LSKNet', embed_dims=[64, 128, 320, 512],
                  depths=[2, 2, 4, 2], mlp_ratios=[8, 8, 4, 4],
                  drop_rate=0.1, drop_path_rate=0.1,
                  norm_cfg=dict(type='SyncBN', requires_grad=True)),
    neck=dict(type='FPN', in_channels=[64, 128, 320, 512], out_channels=256,
              start_level=1, add_extra_convs='on_input', num_outs=5))

MODEL_DICTS = {'swin': SWIN_T_RRETINANET, 'lsknet': LSKNET_S_RRETINANET}


def entry(device='cuda', backbone='resnet'):
    """The flagship model's forward on one device: ``(fn, (images,))``.
    On the card unless ``device='cpu'``; ``backbone='swin'`` builds
    ``SWIN_T_RRETINANET``, ``'lsknet'`` ``LSKNET_S_RRETINANET``."""
    import torch

    from .models.detectors import R3DET_R50_V1, build_detector
    from .utils.builder import build_from_config
    from .utils.convert import seeded_state_dict

    if backbone in MODEL_DICTS:
        model, _ = build_from_config({'model': MODEL_DICTS[backbone]},
                                     dtype=torch.bfloat16, device=device)
    else:
        model = build_detector(R3DET_R50_V1, dtype=torch.bfloat16,
                               device=device)
    model.load_state_dict(seeded_state_dict(model, 0))
    images = torch.zeros((1, 512, 512, 3), dtype=torch.float32,
                         device=device)

    def fn(images):
        with torch.no_grad():
            out = model(images)
        return [t.sum() for t in _leaves((out['s0'], out.get('sr', []),
                                          out.get('rois', [])))]

    return fn, (images,)


def _tiny_cfg():
    from .models.detectors import DetectorConfig, StageTrainCfg
    return DetectorConfig(
        num_classes=3, stacked_convs=1, feat_channels=32, backbone_depth=10,
        num_refine_stages=1, stage_loss_weights=(1.0,),
        s0_train=StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
        sr_train=(StageTrainCfg(0.6, 0.5, 0.0, None),))


def _tiny_batch(b):
    """JAX's dry-run batch: the same ``RandomState(0)`` draws."""
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    gt = np.stack([np.stack([
        rng.uniform(10, SIZE - 10, 4), rng.uniform(10, SIZE - 10, 4),
        rng.uniform(8, 24, 4), rng.uniform(6, 16, 4),
        rng.uniform(-1.4, -0.1, 4)], -1) for _ in range(b)]).astype(
            np.float32)
    return {'image': images, 'gt_bboxes': gt,
            'gt_labels': np.zeros((b, 4), np.int32),
            'gt_mask': np.ones((b, 4), bool)}


def _step(batch, rows, group=None):
    """One SGD step of the seeded tiny model on ``batch``'s ``rows``:
    (loss, the parameters before, after)."""
    import torch

    from .models.detectors import build_detector
    from .parallel import dist
    from .parallel.train import make_train_step
    from .utils.convert import seeded_state_dict

    cfg = _tiny_cfg()
    model = build_detector(cfg, dtype=torch.float32, device='cpu')
    model.load_state_dict(seeded_state_dict(model, 0))
    dist.broadcast_state(model, None, group)
    before = [p.detach().clone() for p in model.parameters()]
    sizes = tuple((max(SIZE // s, 1),) * 2 for s in cfg.strides)
    step = make_train_step(model, cfg, sizes, device='cpu',
                           process_group=group)
    losses = step({k: torch.from_numpy(v[rows]) for k, v in batch.items()})
    dist.check_replicas(model, None, group)
    return (float(losses['total']), before,
            [p.detach().clone() for p in model.parameters()])


def _worker(rank, ranks, store, out):
    """One process of :func:`dryrun_multichip`, on one thread: rank
    ``rank`` of ``ranks`` stepping its image, or (``rank`` None) one
    process stepping the whole batch of ``ranks`` images. Saves the loss
    and the updated parameters (and, alone, those before) to ``out``."""
    import torch

    from .parallel import dist
    torch.set_num_threads(1)
    batch = _tiny_batch(ranks)
    if rank is None:
        loss, before, after = _step(batch, slice(0, ranks))
        torch.save({'loss': loss, 'before': before, 'params': after}, out)
        return
    group = dist.init_distributed('gloo', 'file://' + store, ranks, rank,
                                  timeout_s=RANK_TIMEOUT_S)
    try:
        loss, _, after = _step(batch, slice(rank, rank + 1), group)
    finally:
        torch.distributed.destroy_process_group()
    torch.save({'loss': loss, 'params': after}, out)


def _abs_sum(ts):
    return float(sum(np.abs(t.double().numpy()).sum() for t in ts))


def _diff_sum(a, b):
    return float(sum(np.abs(x.double().numpy() - y.double().numpy()).sum()
                     for x, y in zip(a, b)))


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int) -> None:
    """A data-parallel train step on ``n_devices`` gloo ranks on the CPU,
    held to one process on the global batch (see the module docstring)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1',
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, 'store')
        jobs = [*range(n_devices), None]        # the ranks, then one process
        outs = [os.path.join(tmp, f'{r}.pt') for r in jobs]
        procs = [subprocess.Popen(
            [sys.executable, '-c',
             'from r3det_tpu_torch.dryrun import _worker; '
             f'_worker({r}, {n_devices}, {store!r}, {o!r})'],
            env=env, cwd=REPO) for r, o in zip(jobs, outs)]
        try:
            import torch                    # while the processes start
            codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(codes):
            raise RuntimeError(f'dryrun_multichip: exit codes {codes} '
                               f'(ranks 0..{n_devices - 1}, then the single '
                               'process)')
        *ranks, single = [torch.load(o) for o in outs]
    loss1, before, after1 = single['loss'], single['before'], single['params']
    lossN, afterN = ranks[0]['loss'], ranks[0]['params']
    psum1, psumN = _abs_sum(after1), _abs_sum(afterN)
    delta1, deltaN = _diff_sum(after1, before), _diff_sum(afterN, before)
    _check(np.isfinite(lossN), f'non-finite loss {lossN}')
    _check(abs(lossN - loss1) <= LOSS_RTOL * max(1.0, abs(loss1)),
           f'{n_devices}-rank loss {lossN!r} != 1-process loss {loss1!r}; '
           'the data-parallel loss reduction is broken')
    _check(abs(psumN - psum1) <= PSUM_RTOL * max(1.0, abs(psum1)),
           f'updated params diverge: {n_devices}-rank {psumN!r} vs '
           f'1-process {psum1!r}; the gradient all-reduce is broken')
    _check(deltaN > 0 and delta1 > 0,
           f'train step left params unchanged (delta1={delta1}, '
           f'deltaN={deltaN})')
    _check(all(all(torch.equal(a, b) for a, b in zip(r['params'], afterN))
               for r in ranks[1:]), 'the ranks hold different parameters')
    gap = _diff_sum(afterN, after1)
    _check(gap <= UPDATE_RTOL * delta1,
           f'the {n_devices}-rank update is {gap / delta1:.3g} of the '
           'update away from the 1-process one; the gradient all-reduce is '
           'broken')
    print(f'dryrun_multichip({n_devices}) OK: loss={lossN:.6f} '
          f'(1-process {loss1:.6f}), params updated and equal')


if __name__ == '__main__':
    import torch
    fn, args = entry()
    sums = fn(*args)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(s)) for s in sums):
        raise SystemExit('entry: non-finite output sums')
    print('entry OK')
