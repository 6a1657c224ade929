"""The training driver: the program's train step in a closed loop.

Set-up draws the weights and a pool of synthetic batches on the card from
the seed, builds the program's detector, its optimizer (behind a thin
wrapper that times its update) and its step
(``parallel.train.make_train_step``), and drives that step through its
first steps from the seed on the pool's first batches: the steps the
check compares. The same step object then runs the window, cycling
through the pool; a step ends when its loss is on the host.

Batches follow the program's ``SyntheticDetData``: unit normal images and,
per image, rotated v1 boxes (centres 50 px or more from the border, w
16-120, h 12-80, angle in (-pi/2 + 0.05, -0.05)) with uniform labels,
padded to ``max_gt``. The object counts of the pool's images are the
traffic's ``objects`` list, in an order drawn from the seed, so that every
seed trains on the same amount of work.

Traffic keys: ``batch``, ``size``, ``pool``, ``max_gt``, ``objects``,
``check_steps``, ``trace_steps``.
"""
import math
import time

import torch

from . import check, common
from .trace import Spans, profile_steps, span_steps


class TimedOptimizer:
    """Delegates to the program's optimizer; spans its update."""

    def __init__(self, opt, spans):
        self.opt = opt
        self.spans = spans

    def step(self, grads):
        self.spans.begin('update')
        self.opt.step(grads)
        self.spans.end('update')

    def __getattr__(self, name):
        return getattr(self.opt, name)


def pool_batches(traffic, num_classes, seed, device):
    """The pool of batches (dicts of tensors on ``device``)."""
    b = traffic['batch']
    s, g, p = traffic['size'], traffic['max_gt'], traffic['pool']
    counts = torch.tensor(traffic['objects'], dtype=torch.long)
    if len(counts) != p * b:
        raise ValueError('objects must give one count for every image of '
                         'the pool')
    order = torch.randperm(len(counts), generator=torch.Generator()
                           .manual_seed(common.derive_seed(seed, 4)))
    counts = counts[order].view(p, b).to(device)
    gen = torch.Generator(device).manual_seed(common.derive_seed(seed, 2))
    lo = torch.tensor([50.0, 50.0, 16.0, 12.0, -math.pi / 2 + 0.05],
                      device=device)
    hi = torch.tensor([s - 50.0, s - 50.0, 120.0, 80.0, -0.05],
                      device=device)
    out = []
    for i in range(p):
        image = torch.randn(b, s, s, 3, generator=gen, device=device)
        u = torch.rand(b, g, 5, generator=gen, device=device)
        labels = torch.randint(0, num_classes, (b, g), generator=gen,
                               device=device, dtype=torch.int32)
        mask = torch.arange(g, device=device)[None] < counts[i][:, None]
        boxes = torch.where(mask[..., None], lo + u * (hi - lo),
                            torch.zeros_like(u))
        out.append({'image': image, 'gt_bboxes': boxes,
                    'gt_labels': torch.where(mask, labels, 0),
                    'gt_mask': mask})
    return out


def prepare(ctx):
    """Set-up up to the window: the program's model, optimizer and step,
    the pool, and the checked steps' readings (``prog``)."""
    from r3det_tpu_torch.models.detectors import build_detector
    from r3det_tpu_torch.parallel.train import make_optimizer, make_train_step

    from ..reference.model import Detector
    cfg, traffic, device = ctx['cfg'], ctx['traffic'], ctx['device']
    pcfg = common.program_config(cfg, traffic)
    shell = Detector(common.reference_config(cfg, traffic))  # names, shapes
    state = common.seeded_state(shell, common.derive_seed(ctx['seed'], 1),
                                device)
    del shell
    pool = pool_batches(traffic, cfg['num_classes'], ctx['seed'], device)
    dtype = getattr(torch, cfg['compute_dtype'])
    model = build_detector(pcfg, dtype=dtype, device=device,
                           **cfg.get('build_options', {}))
    model.load_state_dict(state)
    names = [n for n, _ in model.named_parameters()]
    p0 = [p.detach().to('cpu', copy=True) for p in model.parameters()]
    spans = Spans()
    opt = TimedOptimizer(make_optimizer(model.parameters()), spans)
    step = make_train_step(model, pcfg, common.featmap_sizes(
        cfg, traffic['size']), optimizer=opt, device=device.type)

    def one(i):
        return float(step(pool[i % len(pool)])['total'])

    # the checked steps: the window's own call on the pool's first batches
    prog = {'losses': [], 'rois': []}
    hook = model.register_forward_hook(lambda m, a, o: prog['rois'].append(
        [[t.detach() for t in r] for r in o.get('rois', [])]))
    k = traffic['check_steps']
    wd = opt.opt.weight_decay
    for i in range(k):
        prog['losses'].append(one(i))
        if i == 0:
            prog['grad'] = [t.detach().to('cpu', copy=True) - wd * p
                            for t, p in zip(opt.opt.trace, p0)]
    hook.remove()
    prog['change'] = [p.detach().to('cpu', copy=True) - q
                      for p, q in zip(model.parameters(), p0)]
    return dict(model=model, step=step, one=one, opt=opt, spans=spans,
                pool=pool, prog=prog, state=state, names=names)


def run(ctx):
    traffic, device = ctx['traffic'], ctx['device']
    p = prepare(ctx)
    one, k = p['one'], traffic['check_steps']
    for i in range(k, k + len(p['pool'])):             # the rest of the pool
        one(i)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - ctx['t0']
    if device.type == 'cuda':                 # the window's peak from here
        common.log('setup', setup_s=setup_s,
                   setup_peak_bytes=torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)

    n, failed = 0, 0
    start = time.perf_counter()
    while True:
        try:
            one(n)
        except Exception as e:
            failed += 1
            common.log('step_failed', step=n, error=repr(e)[:300])
            if failed >= 3:
                break
        n += 1
        if time.perf_counter() - start >= ctx['seconds']:
            break
    elapsed = time.perf_counter() - start
    done = n - failed
    images = done * traffic['batch']
    res = dict(attempted=n, failed=failed, setup_s=setup_s, window_s=elapsed,
               steps=done, e2e={'train_images_per_s': images / elapsed,
                                'setup_s': setup_s})
    common.log('window', steps=done, seconds=elapsed,
               train_images_per_s=images / elapsed)
    if ctx['trace']:
        res['layer'] = traced(p, traffic, res)
    res['memory_peak_bytes'] = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    prog, state, names, pool = p['prog'], p['state'], p['names'], p['pool']
    del p
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    t = time.perf_counter()
    refd = reference_steps(common.reference_config(ctx['cfg'], traffic),
                           ctx['cfg']['optimizer'], state,
                           [pool[i % len(pool)] for i in range(k)], names,
                           device, rois=prog['rois'])
    numbers, leaves = check.train_numbers(prog, refd, names)
    common.log('check_detail', losses=prog['losses'],
               ref_losses=refd['losses'], **leaves)
    res.update(numbers=numbers, check_s=time.perf_counter() - t)
    return res


def reference_steps(rcfg, opt_cfg, state, batches, names, device,
                    quant=None, rois=None, keep=None):
    """The reference's steps from the same weights on the same batches:
    {'losses', 'grad', 'change', 'rois'}, leaves in the order of
    ``names``. The refine stages follow ``rois`` (the program's, one list
    a step), since ``filter_bboxes`` is an argmax over nearly tied anchor
    logits at the seeded initialisation, which flips between precisions;
    ``roi_dist`` then judges those rois against each step's reference base
    head (``check.roi_numbers``, the worst step). ``quant`` ('int8' or
    'fp8') computes every conv in that precision (a control); ``keep``
    plants the half-batch fault."""
    from ..reference.model import Detector
    from ..reference.train import train_steps
    ref = Detector(rcfg).to(device)
    ref.load_state_dict(state)
    if quant:
        for m in ref.modules():
            m.quant = quant
    if rois is not None and any(r[0][0].shape[0] != b['image'].shape[0]
                                for r, b in zip(rois, batches) if r):
        rois = None             # the half-batch fault's rois: not followed
    order = [n for n, _ in ref.named_parameters()]
    r0 = [p.detach().clone() for p in ref.parameters()]
    with check.no_tf32():
        losses, grad, used, heads = train_steps(ref, batches, rcfg, opt_cfg,
                                                rois, keep)
    change = [(p.detach() - q).cpu() for p, q in zip(ref.parameters(), r0)]
    at = {n: i for i, n in enumerate(order)}
    out = {'losses': losses, 'grad': [grad[at[n]].cpu() for n in names],
           'change': [change[at[n]] for n in names], 'rois': used}
    if rois is not None and rcfg['num_refine_stages']:
        out['roi_dist'] = max(
            check.roi_numbers(r[0], {'s0': h}, rcfg)['roi_dist']
            for r, h in zip(rois, heads))
    return out


def traced(p, traffic, res):
    spans, one = p['spans'], p['one']
    steps = traffic['trace_steps']
    spans.hook(p['model'], 'forward')
    totals = span_steps(one, steps, spans)
    spans.remove()
    trace, loop_s = profile_steps(one, steps)
    rate = steps * traffic['batch'] / loop_s
    common.log('tracing_overhead', untraced_images_per_s=res['e2e']
               ['train_images_per_s'], traced_images_per_s=rate,
               overhead=1 - rate / res['e2e']['train_images_per_s'])
    return dict(trace=trace, spans=totals, steps=steps, traced_s=loop_s)
