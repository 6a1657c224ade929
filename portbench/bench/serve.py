"""The serving driver: the program's predict step in a closed loop.

Set-up draws the weights and a pool of image batches on the card from the
seed, shapes the final cls layers (``common.shape_cls``), builds the
program's detector and its step (``parallel.predict.make_predict_step``)
and runs each pool batch once. The window then issues the next batch as
soon as the last one's detections are on the host, cycling through the
pool, for the run's seconds. A step's latency runs from its call to its
detections on the host.

Two steps of the window, drawn from the seed, keep the model's outputs,
the inputs of each stage that the check judges (forward hooks,
``capture``) and their detections for the check, which runs after the
window, once the program is freed (``check.serve_numbers``).

Traffic keys: ``batch``, ``size``, ``pool``, ``image`` ({"low", "high"}:
uniform pixels), ``shape`` (the cls layers to shape, with their ``live``
targets), ``calibration_images``, ``test_cfg`` and ``model_options``
(overrides of the configuration), ``trace_steps``.
"""
import random
import time

import torch

from . import check, common
from .trace import Spans, profile_steps, span_steps

SAMPLES = 2             # window steps whose outputs the check compares


def images(gen, n, size, spec, device):
    lo, hi = spec['low'], spec['high']
    return torch.rand(n, size, size, 3, generator=gen, device=device) \
        * (hi - lo) + lo


def build(cfg, traffic, seed, device):
    """Everything set-up makes: {'ref', 'model', 'step', 'pool', ...}."""
    from r3det_tpu_torch.models.detectors import build_detector
    from r3det_tpu_torch.models.quant import calibrate
    from r3det_tpu_torch.parallel.predict import make_predict_step

    from ..reference.model import Detector
    rcfg = common.reference_config(cfg, traffic)
    pcfg = common.program_config(cfg, traffic)
    ref = Detector(rcfg).to(device)
    state = common.seeded_state(ref, common.derive_seed(seed, 1), device)
    size, batch = traffic['size'], traffic['batch']
    gen = torch.Generator(device).manual_seed(common.derive_seed(seed, 2))
    pool = [images(gen, batch, size, traffic['image'], device)
            for _ in range(traffic['pool'])]
    with check.no_tf32():
        shaped = common.shape_cls(state, ref, rcfg,
                                  pool[0][:traffic['calibration_images']],
                                  traffic['shape'])
    opts = dict(cfg.get('build_options', {}),
                **traffic.get('model_options', {}))
    # options that are config fields (quantize, quantize_head) go there
    pcfg = pcfg._replace(**{k: opts.pop(k) for k in list(opts)
                            if k in pcfg._fields})
    dtype = getattr(torch, cfg['compute_dtype'])
    model = build_detector(pcfg, dtype=dtype, device=device, **opts)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected or any(not k.endswith(('act_absmax', 'in_absmax'))
                         for k in missing):
        raise RuntimeError(f'weights do not fit the program: missing '
                           f'{missing}, unexpected {unexpected}')
    if missing:                            # int8 activation ranges
        with torch.no_grad():
            calibrate(model, pool[:1])
    sizes = common.featmap_sizes(cfg, size)
    step = make_predict_step(model, pcfg, sizes, img_shape=(size, size))
    return dict(ref=ref, rcfg=rcfg, model=model, step=step, pool=pool,
                sizes=sizes, shaped=shaped)


def capture(model, into):
    """Forward hooks keeping, of the model's last call, what the check
    judges stage by stage: the model's outputs (``into['out']``), the
    FPN's (``'fpn'``), each FRM's (``'frm0'``, ...) and, level by level,
    the input of each head's final cls and reg convs (``'tower.s0.cls'``,
    ``'tower.sr0.reg'``, ...)."""
    def keep(key):
        return lambda m, a, o: into.__setitem__(key, o)

    def feed(key):
        return lambda m, a: into.setdefault(key, []).append(a[0])

    hooks = [model.register_forward_pre_hook(lambda m, a: into.clear()),
             model.register_forward_hook(keep('out')),
             model.neck.register_forward_hook(keep('fpn'))]
    heads = [('s0', model.bbox_head)]
    i = 0
    while hasattr(model, f'frm_{i}'):
        hooks.append(getattr(model, f'frm_{i}').register_forward_hook(
            keep(f'frm{i}')))
        heads.append((f'sr{i}', getattr(model, f'refine_head_{i}')))
        i += 1
    for key, head in heads:
        for branch in ('cls', 'reg'):
            hooks.append(getattr(head, f'retina_{branch}')
                         .register_forward_pre_hook(
                             feed(f'tower.{key}.{branch}')))
    return hooks


def peak(device):
    return torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run(ctx):
    cfg, traffic, device = ctx['cfg'], ctx['traffic'], ctx['device']
    b = build(cfg, traffic, ctx['seed'], device)
    model, step, pool = b['model'], b['step'], b['pool']
    batch = traffic['batch']
    last = {}
    hooks = capture(model, last)

    def one(i):
        slot = i % len(pool)
        t = time.perf_counter()
        dets, labels, num = step(pool[slot])
        got = (dets.cpu(), labels.cpu(), num.cpu())
        return slot, got, time.perf_counter() - t

    for i in range(len(pool) + 1):                       # warm-up
        one(i)
    sync(device)
    setup_s = time.perf_counter() - ctx['t0']
    common.log('setup', setup_s=setup_s, shaped=b['shaped'],
               setup_peak_bytes=peak(device))
    if device.type == 'cuda':                 # the window's peak from here
        torch.cuda.reset_peak_memory_stats(device)

    rng = random.Random(common.derive_seed(ctx['seed'], 3))
    samples, lat, failed = [], [], 0
    start = time.perf_counter()
    n = 0
    while True:
        try:
            slot, got, dt = one(n)
        except Exception as e:                # a failed step counts
            failed += 1
            common.log('step_failed', step=n, error=repr(e)[:300])
            if failed >= 3:
                break
            n += 1
            continue
        lat.append(dt)
        item = (slot, dict(last), got)
        if len(samples) < SAMPLES:
            samples.append(item)
        else:
            j = rng.randrange(n + 1)
            if j < SAMPLES:
                samples[j] = item
        n += 1
        if time.perf_counter() - start >= ctx['seconds']:
            break
    elapsed = time.perf_counter() - start
    done = len(lat)
    res = dict(attempted=n, failed=failed, setup_s=setup_s,
               window_s=elapsed, steps=done,
               e2e={'patches_per_s': done * batch / elapsed,
                    'setup_s': setup_s},
               latency_ms=[x * 1e3 for x in lat])
    common.log('window', steps=done, seconds=elapsed,
               patches_per_s=res['e2e']['patches_per_s'],
               step_ms_p50=common.quantile(res['latency_ms'], 0.5),
               step_ms_p95=common.quantile(res['latency_ms'], 0.95))

    if ctx['trace']:
        res['layer'] = traced(model, traffic, pool, b, res)
    for h in hooks:
        h.remove()
    res['memory_peak_bytes'] = peak(device)
    del step, model, b['model'], b['step'], last
    if device.type == 'cuda':
        torch.cuda.empty_cache()

    # the check, after the window, on the freed card
    t = time.perf_counter()
    checked = [(pool[slot], out, got) for slot, out, got in samples]
    numbers, live = check.serve_numbers(checked, b['ref'], b['rcfg'],
                                        b['sizes'], (traffic['size'],) * 2)
    common.log('traffic', live_per_image=live,
               live_mean=sum(live) / max(len(live), 1),
               steps_checked=len(samples))
    res.update(numbers=numbers, check_s=time.perf_counter() - t,
               live=live)
    return res


def traced(model, traffic, pool, b, res):
    """The traced sub-windows: module spans from CUDA events (no
    profiler), then the device trace, and what the per-layer readers
    need."""
    from ..reference import predict as rpred
    from ..work.kernels import near_pairs
    spans = Spans()
    for name in ('backbone', 'neck', 'bbox_head', 'frm_0', 'refine_head_0'):
        if hasattr(model, name):
            spans.hook(getattr(model, name), name)
    spans.hook(model, 'forward')
    step = b['step']
    steps = traffic['trace_steps']

    def run_step(i):
        spans.begin('predict')
        dets, labels, num = step(pool[i % len(pool)])
        spans.end('predict')
        (dets.cpu(), labels.cpu(), num.cpu())

    totals = span_steps(run_step, steps, spans)
    spans.remove()
    capture = {}
    hook = model.register_forward_hook(
        lambda m, a, o: capture.setdefault(len(capture), o)
        if len(capture) < len(pool) else None)
    trace, loop_s = profile_steps(run_step, steps)
    hook.remove()
    # the live candidates and meeting pairs of each pool batch, for K1
    work = []
    with torch.no_grad():
        for i in range(min(len(pool), steps)):
            boxes, scores = rpred.candidates(capture[i], b['rcfg'],
                                             b['sizes'],
                                             (traffic['size'],) * 2)
            sel = rpred.select(boxes, scores, b['rcfg'])
            lv = [int(v) for v in sel[3]]
            work.append((lv, sum(near_pairs(sel[0][k], v)
                                 for k, v in enumerate(lv))))
    rate = steps * traffic['batch'] / loop_s
    common.log('tracing_overhead', untraced_patches_per_s=res['e2e']
               ['patches_per_s'], traced_patches_per_s=rate,
               overhead=1 - rate / res['e2e']['patches_per_s'])
    return dict(trace=trace, spans=totals, steps=steps, kernel_work=work,
                traced_s=loop_s)
