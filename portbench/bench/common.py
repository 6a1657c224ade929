"""What every driver shares: the program's config from the benchmark's
configuration file, the seeded weights, the shaping of a final cls layer,
the card's description, statistics and the result's last line."""
import json
import math
import subprocess
import sys

import torch

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'r3det_tpu')
PEAK_BF16 = 989e12                # H100 SXM data sheet, dense bf16 FLOP/s


def derive_seed(seed, stream):
    """A 62-bit seed for one stream of draws (weights, images, boxes...)
    of the run's ``--seed``."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (1 << 62)


def program_config(cfg, traffic=None):
    """The program's ``DetectorConfig`` for a configuration dict, with the
    traffic's ``test_cfg`` overrides."""
    from r3det_tpu_torch.models.detectors import (DetectorConfig,
                                                  StageTrainCfg, TestCfg)
    test = dict(cfg['test'], **(traffic or {}).get('test_cfg', {}))
    fields = {k: _tuples(v) for k, v in cfg.items()
              if k in DetectorConfig._fields}
    fields['s0_train'] = StageTrainCfg(**cfg['s0_train'])
    fields['sr_train'] = tuple(StageTrainCfg(**s) for s in cfg['sr_train'])
    fields['test'] = TestCfg(**test)
    return DetectorConfig(**fields)


def _tuples(v):
    """``v`` with every list in it a tuple, so that it hashes."""
    return tuple(map(_tuples, v)) if isinstance(v, list) else v


def reference_config(cfg, traffic=None):
    """The configuration dict with the traffic's ``test_cfg`` overrides."""
    out = dict(cfg)
    out['test'] = dict(cfg['test'], **(traffic or {}).get('test_cfg', {}))
    return out


def featmap_sizes(cfg, size):
    return tuple((math.ceil(size / s), math.ceil(size / s))
                 for s in cfg['strides'])


def seeded_state(model, seed, device):
    """The configuration's initial weights for the names of ``model``'s
    (a reference ``Detector``'s) state dict, drawn on ``device`` from
    ``seed`` in one normal draw, in the state dict's order.

    A tensor that is not floating point keeps the value the module built
    it with. A name under ``backbone.`` is first offered, without that
    prefix, to the backbone file's ``seed_rule(name, shape)``, which
    returns ``('normal', std)`` (the tensor joins the draw), ``('fill',
    value)`` or None. The shared rule: 4-D convs (the stem kernel and
    trunk convs) normal(0, fan_in^-1/2), the head and FRM convs normal(0,
    0.01), the cls biases at the focal prior (p = 0.01), FrozenBN scale and
    var 1, every other tensor 0."""
    gen = torch.Generator(device).manual_seed(int(seed))
    sd = model.state_dict()
    rule = getattr(model, 'seed_rule', None)
    normal, stds, out = [], [], {}
    for name, t in sd.items():
        leaf = name.rsplit('.', 1)[-1]
        shape = tuple(t.shape)
        head = name.startswith(('bbox_head.', 'refine_head_', 'frm_'))
        if not t.is_floating_point():
            out[name] = t.to(device, copy=True)
            continue
        own = rule(name[len('backbone.'):], shape) \
            if rule and name.startswith('backbone.') else None
        if own is not None:
            kind, value = own
            if kind == 'normal':
                normal.append(name)
                stds.append(value)
            elif kind == 'fill':
                out[name] = torch.full(shape, value, device=device)
            else:
                raise ValueError(f'seed_rule gave {own!r} for {name}')
        elif leaf in ('kernel', 'weight') and len(shape) == 4:
            fan = math.prod(shape[:3]) if leaf == 'kernel' \
                else math.prod(shape[1:])
            normal.append(name)
            stds.append(0.01 if head and leaf == 'weight' else fan ** -0.5)
        elif name.endswith('retina_cls.bias'):
            out[name] = torch.full(shape, -math.log(99.0), device=device)
        elif leaf in ('scale', 'var'):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    sizes = [sd[n].numel() for n in normal]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.repeat_interleave(
        torch.tensor(stds, device=device), torch.tensor(sizes, device=device))
    for name, piece in zip(normal, (flat * scale).split(sizes)):
        out[name] = piece.view(sd[name].shape)
    return {n: out[n] for n in sd}


def _level_top(logits, rows, nms_pre):
    """(B, N, C) logits, ``rows`` of them a level -> the per-level top
    ``nms_pre`` rows' (B, M, C) logits, as decode selects them."""
    kept, start = [], 0
    for n in rows:
        lvl = logits[:, start:start + n]
        start += n
        k = min(nms_pre, n)
        idx = torch.sort(lvl.amax(-1), dim=1, descending=True,
                         stable=True).indices[:, :k]
        kept.append(lvl.gather(1, idx[..., None].expand(-1, -1,
                                                        lvl.shape[-1])))
    return torch.cat(kept, 1)


def shape_cls(state, ref, cfg, images, shapes):
    """Traffic shaping of final cls layers, from float32 forwards of the
    reference on ``images``, one a layer in the order of ``shapes``: each
    named layer has its weights rescaled so that its logits spread with
    unit std over the images (seeded weights give logits within 0.01 of
    the prior, which makes every argmax a tie), and, where the entry asks
    for ``live`` candidates an image, its bias set so that the median
    image sends that many (position, class) pairs above ``score_thr`` to
    NMS. ``state`` is updated in place; returns {layer: (scale, bias)}."""
    c = cfg['num_classes']
    result = {}
    for s in shapes:
        layer = s['layer']
        ref.load_state_dict(state)
        got = []
        hook = ref.get_submodule(layer).register_forward_hook(
            lambda m, i, o: got.append(o.detach()))
        try:
            with torch.no_grad():
                ref(images)
        finally:
            hook.remove()
        bias = state[f'{layer}.bias'].view(1, -1, 1, 1)
        flat = torch.cat([(t - bias).permute(0, 2, 3, 1)
                          .reshape(t.shape[0], -1, c) for t in got], 1)
        k = 1.0 / float(flat.std())
        state[f'{layer}.weight'].mul_(k)
        b0 = float(state[f'{layer}.bias'][0])
        if s.get('live'):
            rows = [t.shape[2] * t.shape[3] * t.shape[1] // c for t in got]
            top = _level_top(flat * k, rows, cfg['test']['nms_pre'])
            ordered = torch.sort(top.reshape(top.shape[0], -1), dim=1,
                                 descending=True).values
            p = cfg['test']['score_thr']
            b0 = math.log(p / (1 - p)) - float(ordered[:, s['live']].median())
            state[f'{layer}.bias'].fill_(b0)
        result[layer] = (k, b0)
    ref.load_state_dict(state)
    return result


def quantile(values, q):
    """The q-quantile of all ``values`` (linear between order statistics,
    numpy's default)."""
    v = sorted(values)
    if not v:
        return float('nan')
    pos = (len(v) - 1) * q
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def card_info(device):
    """nvidia-smi's name and power limit of the card."""
    idx = device.index or 0
    try:
        line = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', '-i', str(idx)], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = ''
    return line or torch.cuda.get_device_name(device)


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(tag, **fields):
    print(f'[{tag}] ' + ' '.join(f'{k}={v}' for k, v in fields.items()),
          file=sys.stderr, flush=True)


def emit(result):
    print(json.dumps(result), flush=True)
