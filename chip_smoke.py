#!/usr/bin/env python3
"""Smoke run of the r3det_tpu_torch serving path on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is 1):

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels (``r3det_tpu_torch/csrc``) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (max |diff| within the stated
   tolerance; both times from CUDA events after warm-up);
4. end to end: R3Det* tiny (stacked_convs=2, angle v1), ResNet-50, full
   width, bf16, batch 8 of 1024^2 patches, weights from a numpy seed,
   through ``build_detector`` and the port's predict step. The refine
   head's final cls layer is set from the seed so that one batch sends more
   than 2000 live candidates per image to NMS (the full sweep) and the
   other fewer (the small sweep); every kernel must launch in that run.
   The same batches then go through the plain versions on the card.

Prints the kernels' JSON record on the line before the last, and as the
last line ``{"ok": true, "device": {...}}``. Needs one card; exits non-zero
without one, and without the rest of the repository.
"""
import json
import math
import os
import subprocess
import sys
import time

SEED = 0
BATCH = 8
SIZE = 1024
# main-path shapes of each kernel
IOU_BUDGETS = (4000, 2000)        # NMS candidate budgets: full and small
FRM_SIZES = (128, 64, 32, 16, 8)  # P3..P7 at 1024^2
FRM_CHANNELS = 256
LIVE_TARGETS = {'big': 3000, 'small': 1000}   # live candidates per image
REPLACES = {
    'rotated_iou': 'r3det_tpu/ops/pallas_iou.py:146',
    'frm_sample': 'r3det_tpu/ops/frm_sample.py:241',
    'stem_conv_pool': 'r3det_tpu/ops/stem_pool.py:586',
}
SOURCES = {
    'rotated_iou': 'r3det_tpu_torch/csrc/rotated_iou.cu',
    'frm_sample': 'r3det_tpu_torch/csrc/frm_sample.cu',
    'stem_conv_pool': 'r3det_tpu_torch/csrc/stem_pool.cu',
}


def phase(tag, **fields):
    print(f"[{tag}] " + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# phase 3 inputs (numpy seeded, moved to the card)
# ---------------------------------------------------------------------------

def iou_boxes(rng, b, k):
    """Candidate-like boxes with identical, touching and parallel-edge
    pairs mixed in."""
    import numpy as np
    boxes = np.stack([rng.uniform(0, SIZE, (b, k)),
                      rng.uniform(0, SIZE, (b, k)),
                      rng.uniform(4, 160, (b, k)), rng.uniform(4, 160, (b, k)),
                      rng.uniform(-math.pi / 2, math.pi / 2, (b, k))], -1)
    n = k // 16
    boxes[:, 1:n:2] = boxes[:, 0:n - 1:2]                         # identical
    touch = boxes[:, n:2 * n:2].copy()                            # touching
    touch[..., 0] += touch[..., 2] * np.cos(touch[..., 4])
    touch[..., 1] += touch[..., 2] * np.sin(touch[..., 4])
    boxes[:, n + 1:2 * n:2] = touch[:, :boxes[:, n + 1:2 * n:2].shape[1]]
    par = boxes[:, 2 * n:3 * n:2].copy()                          # parallel
    par[..., 0] += 0.5 * par[..., 2] * np.cos(par[..., 4])
    par[..., 1] += 0.5 * par[..., 2] * np.sin(par[..., 4])
    boxes[:, 2 * n + 1:3 * n:2] = par[:, :boxes[:, 2 * n + 1:3 * n:2].shape[1]]
    return boxes.astype(np.float32)


def frm_rois(rng, b, h, w, stride):
    """Best boxes near their cells (as filter_bboxes gives them), some far
    off and some outside the image."""
    import numpy as np
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    cx = (jj * stride)[None] + rng.uniform(-2, 2, (b, h, w)) * stride
    cy = (ii * stride)[None] + rng.uniform(-2, 2, (b, h, w)) * stride
    far = rng.uniform(size=(b, h, w)) < 0.05
    cx = np.where(far, rng.uniform(-0.2 * SIZE, 1.2 * SIZE, (b, h, w)), cx)
    cy = np.where(far, rng.uniform(-0.2 * SIZE, 1.2 * SIZE, (b, h, w)), cy)
    rois = np.stack([cx, cy, rng.uniform(8, 128, (b, h, w)),
                     rng.uniform(8, 128, (b, h, w)),
                     rng.uniform(-1.5, 1.5, (b, h, w))], -1)
    return rois.reshape(b, h * w, 5).astype(np.float32)


def compare_kernels(dev):
    """Phase 3: every kernel vs its plain version at main-path shapes."""
    import numpy as np
    import torch

    from r3det_tpu_torch.ops import frm_sample as K2
    from r3det_tpu_torch.ops import rotated_iou as K1
    from r3det_tpu_torch.ops import stem_pool as K3

    rng = np.random.RandomState(SEED)
    rec = {}

    # K1: f32, exact formula, same operation order -> 1e-5
    for k in IOU_BUDGETS:
        boxes = torch.from_numpy(iou_boxes(rng, BATCH, k)).to(dev)
        vc = torch.from_numpy(rng.randint(k // 4, k + 1, BATCH)
                              .astype(np.int32)).to(dev)
        vc[0] = k                                       # one full image
        args = dict(upper_only=True, valid_count=vc)
        got = K1.rotated_iou_cuda(boxes, boxes, **args)
        want = K1.rotated_iou_reference(boxes, boxes, **args)
        full = K1.rotated_iou_cuda(boxes, boxes)
        full_want = K1.rotated_iou_reference(boxes, boxes)
        err = max(float((got - want).abs().max()),
                  float((full - full_want).abs().max()))
        iof = K1.rotated_iou_cuda(boxes[:1], boxes[:1], mode='iof')
        iof_err = float((iof - K1.rotated_iou_reference(
            boxes[:1], boxes[:1], mode='iof')).abs().max())
        diag = float((torch.diagonal(full, dim1=1, dim2=2) - 1).abs().max())
        ms = cuda_ms(lambda: K1.rotated_iou_cuda(boxes, boxes, **args), 20)
        plain_ms = cuda_ms(
            lambda: K1.rotated_iou_reference(boxes, boxes, **args), 3)
        phase('kernel', name='rotated_iou', shape=f'({BATCH},{k},{k})',
              max_abs_err=err, iof_err=iof_err, self_iou_err=diag,
              tol=1e-5, ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}')
        check(err <= 1e-5 and iof_err <= 1e-5 and diag <= 1e-4,
              f'rotated_iou K={k} disagrees with its plain version')
        if k == IOU_BUDGETS[0]:
            rec['rotated_iou'] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms)

    # K2: bf16, same operation order -> within one bf16 ulp of the value
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for s in FRM_SIZES:
        stride = SIZE // s
        shape = (BATCH, s, s, FRM_CHANNELS)
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)
        feat = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)
        rois = torch.from_numpy(frm_rois(rng, BATCH, s, s, stride)).to(dev)
        got = K2.frm_sample_cuda(x, feat, rois, 1.0 / stride)
        want = K2.frm_sample_reference(x, feat, rois, 1.0 / stride)
        diff = (got.float() - want.float()).abs()
        ulp = want.float().abs() * 2.0 ** -7 + 1e-6
        err = float(diff.max())
        ms = cuda_ms(lambda: K2.frm_sample_cuda(x, feat, rois, 1 / stride),
                     20)
        plain_ms = cuda_ms(
            lambda: K2.frm_sample_reference(x, feat, rois, 1 / stride), 5)
        phase('kernel', name='frm_sample', shape=str(shape),
              max_abs_err=err, exact_frac=float((diff == 0).float().mean()),
              tol='1 bf16 ulp', ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}')
        check(bool((diff <= ulp).all()),
              f'frm_sample at {s}x{s} disagrees with its plain version')
        tot['max_abs_err'] = max(tot['max_abs_err'], err)
        tot['ms'] += ms
        tot['plain_ms'] += plain_ms
    rec['frm_sample'] = tot

    # K3: bf16 out, f32 sums in another order -> atol 1e-2 + rtol 1e-2
    x12 = torch.from_numpy(rng.uniform(-2, 2, (BATCH, SIZE // 2, SIZE // 2, 12))
                           .astype(np.float32)).to(dev, torch.bfloat16)
    kern = torch.from_numpy(rng.normal(0, 0.1, (4, 4, 12, 64))
                            .astype(np.float32)).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 2, 64).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)).to(dev)
    got = K3.stem_conv_pool_cuda(x12, kern, scale, bias)
    want = K3.stem_conv_pool_reference(x12, kern, scale, bias)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ms = cuda_ms(lambda: K3.stem_conv_pool_cuda(x12, kern, scale, bias), 20)
    plain_ms = cuda_ms(
        lambda: K3.stem_conv_pool_reference(x12, kern, scale, bias), 5)
    phase('kernel', name='stem_conv_pool', shape=str(tuple(got.shape)),
          max_abs_err=err, exact_frac=float((diff == 0).float().mean()),
          tol='1e-2 + 1e-2*|ref|', ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}')
    check(bool((diff <= 1e-2 + 1e-2 * want.float().abs()).all()),
          'stem_conv_pool disagrees with its plain version')
    rec['stem_conv_pool'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rec


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _sr_logits(model, images):
    """Refine-head cls logits, all levels: (B, N, C) f32."""
    import torch
    with torch.no_grad():
        out = model(images)
    cls = out['sr'][-1][0]
    c = model.cfg.num_classes
    return torch.cat([t.reshape(t.shape[0], -1, c) for t in cls], 1)


def calibrate_cls(model, images, featmap_sizes):
    """Set the refine head's final cls layer from the seeded forward pass:
    weights rescaled so its logits spread with unit std, and one bias per
    target so each batch reaches its live-candidate count. Returns
    {branch: bias}."""
    import torch
    head = model.refine_head_0.retina_cls
    base = float(head.bias.detach()[0])
    logits = _sr_logits(model, images) - base
    with torch.no_grad():
        head.weight.mul_(1.0 / float(logits.std()))
    logits = _sr_logits(model, images) - base
    # the candidates NMS sees: per level the top nms_pre positions
    nms_pre = model.cfg.test.nms_pre
    kept, start = [], 0
    for h, w in featmap_sizes:
        lvl = logits[:, start:start + h * w]
        start += h * w
        k = min(nms_pre, h * w)
        idx = torch.sort(lvl.amax(-1), dim=1, descending=True,
                         stable=True).indices[:, :k]
        kept.append(lvl.gather(1, idx[..., None].expand(-1, -1, lvl.shape[-1])))
    flat = torch.sort(torch.cat(kept, 1).reshape(logits.shape[0], -1), dim=1,
                      descending=True).values
    thr = math.log(model.cfg.test.score_thr / (1 - model.cfg.test.score_thr))
    biases = {}
    for branch, target in LIVE_TARGETS.items():
        # the image with the most live candidates decides the branch
        biases[branch] = thr - float(flat[:, target].max()) \
            if branch == 'small' else thr - float(flat[:, target].min())
    return biases


def _set_bias(model, value):
    import torch
    with torch.no_grad():
        model.refine_head_0.retina_cls.bias.fill_(value)


def _agreement(a, b):
    """Fraction of detections of run a found in run b (same label, box and
    score within 1e-2 relative), over the batch."""
    import torch
    (da, la, na), (db, lb, nb) = a, b
    found = total = 0
    for i in range(da.shape[0]):
        xa, xb = da[i, :int(na[i])], db[i, :int(nb[i])]
        if len(xa) == 0:
            continue
        same = (la[i, :int(na[i])][:, None] == lb[i, :int(nb[i])][None]) & \
            ((xa[:, None] - xb[None]).abs()
             <= 1e-2 * (xa[:, None].abs() + 1)).all(-1)
        found += int(same.any(1).sum())
        total += len(xa)
    return found / max(total, 1)


def end_to_end(dev, card):
    """Phase 4. Returns the launch counts of the main-path run."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.detectors import (R3DET_R50_V1, TestCfg,
                                                  build_detector,
                                                  detector_predict,
                                                  use_kernels)
    from r3det_tpu_torch.parallel.predict import make_predict_step
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    cfg = R3DET_R50_V1._replace(
        stacked_convs=2, test=TestCfg(approx_topk=False, nms_candidates=None))
    model = build_detector(cfg, dtype=torch.bfloat16)
    model.load_state_dict(seeded_state_dict(model, SEED))
    model = model.to(device=dev, memory_format=torch.channels_last)
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.uniform(-2, 2, (BATCH, SIZE, SIZE, 3))
                              .astype(np.float32)).to(dev)
    sizes = tuple((SIZE // s, SIZE // s) for s in cfg.strides)
    step = make_predict_step(model, cfg, sizes, img_shape=(SIZE, SIZE))
    biases = calibrate_cls(model, images, sizes)

    def run(branch):
        _set_bias(model, biases[branch])
        return step(images, return_branch=True)

    # the main-path run: counts from zero, both NMS branches
    torch.cuda.synchronize()
    _ext.reset_launches()
    results = {br: run(br) for br in LIVE_TARGETS}
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    phase('launches', **launches)
    for name, n in launches.items():
        check(n > 0, f'kernel {name} was not launched on the main path')

    for branch, (dets, labels, num, (live, taken)) in results.items():
        phase('predict', batch=branch, live=live, branch=taken,
              num=num.tolist())
        check(taken == branch, f'expected the {branch} NMS branch, '
                               f'took {taken} (live {live})')
        check(tuple(dets.shape) == (BATCH, cfg.test.max_per_img, 6)
              and tuple(labels.shape) == (BATCH, cfg.test.max_per_img)
              and tuple(num.shape) == (BATCH,), 'wrong output shapes')
        check(bool(torch.isfinite(dets).all()), 'non-finite detections')
        check(bool((num > 0).all()), 'an image has no detection')

    # NMS alone: the same head outputs through K1 and through the plain IoU
    # must keep the same boxes
    for branch in LIVE_TARGETS:
        _set_bias(model, biases[branch])
        with torch.no_grad():
            out = model(images)
        k = detector_predict(out, cfg, sizes, img_shape=(SIZE, SIZE))
        p = detector_predict(out, cfg, sizes, img_shape=(SIZE, SIZE),
                             kernels=False)
        same = all(torch.equal(u, v) for u, v in zip(k, p))
        phase('nms_parity', batch=branch, identical=same)
        check(same, f'NMS with K1 differs from the plain IoU ({branch})')

    # speed, then the plain versions on the card
    def rate(branch, iters=5):
        _set_bias(model, biases[branch])
        step(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(images)
        torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t0)

    speed = {br: rate(br) for br in LIVE_TARGETS}
    kernel_logits = _sr_logits(model, images)
    use_kernels(model, False)
    plain = {br: run(br) for br in LIVE_TARGETS}
    plain_speed = {br: rate(br) for br in LIVE_TARGETS}
    plain_logits = _sr_logits(model, images)
    use_kernels(model, True)
    # the stem kernel's f32 sums round a few bf16 outputs the other way
    # (phase 3); through 50 bf16 layers that moves the logits slightly, and
    # NMS on bf16-tied scores amplifies it, so detections agree closely
    # but not exactly
    rel = float((kernel_logits - plain_logits).abs().max()
                / plain_logits.abs().max())
    phase('forward_parity', sr_logits_max_rel_diff=f'{rel:.5f}', tol=0.05)
    check(rel <= 0.05, 'the forward pass with kernels drifts from plain')
    for branch in LIVE_TARGETS:
        kd, pd = results[branch][:3], plain[branch][:3]
        found, back = _agreement(kd, pd), _agreement(pd, kd)
        phase('e2e', batch=branch, patches_per_s=f'{speed[branch]:.2f}',
              plain_patches_per_s=f'{plain_speed[branch]:.2f}',
              dets_found_in_plain=f'{found:.4f}',
              plain_found_in_kernel=f'{back:.4f}', tol=0.75,
              num=kd[2].tolist(), plain_num=pd[2].tolist(), card=card)
        check(min(found, back) >= 0.75,
              f'kernel and plain detections disagree ({branch})')
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from r3det_tpu_torch import _ext

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase('device', name=repr(name), count=count)
    print(smi, flush=True)

    t0 = time.perf_counter()
    path = _ext.build()
    _ext.lib()
    phase('build', seconds=f'{time.perf_counter() - t0:.2f}',
          library=os.path.relpath(path))

    rec = compare_kernels(dev)
    launches = end_to_end(dev, smi)
    kernels = [dict(name=k, route='cuda', source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[k],
                    max_abs_err=rec[k]['max_abs_err'], ms=rec[k]['ms'],
                    plain_ms=rec[k]['plain_ms']) for k in SOURCES]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
