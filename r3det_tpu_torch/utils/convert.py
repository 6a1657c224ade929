"""Weight bridge from the JAX package's flax variables, and seeded weights.

:func:`from_flax` maps a flax variable tree (``{'params': ...,
'batch_stats': ...}``, leaves as numpy-convertible arrays) onto the port's
``state_dict`` by tree path: the port's modules carry the flax names
(``backbone/layer1_0/conv1`` -> ``backbone.layer1_0.conv1``), so the
mapping is mechanical:

- a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW);
- the stem's folded ``backbone/conv1/kernel`` (4, 4, 12, 64) stays HWIO as
  ``backbone.conv1.kernel``, the layout the stem kernel reads;
- ``bias`` and FrozenBN ``scale``/``bias`` are parameters, ``batch_stats``
  ``mean``/``var`` buffers;
- the int8 ``quant_stats`` (each ``QConv``'s ``act_absmax`` and each int8
  ``Bottleneck``'s ``in_absmax``, scalars) are buffers of the same name.

:func:`seeded_state_dict` makes a full state dict from a numpy seed, with
the reference's initialisation (normal(0.01) head and FRM convs, focal
prior cls bias) and lecun-normal backbone/neck convs, for runs that need
weights but have no checkpoint. A Swin backbone's linears are
lecun-normal too, its LayerNorm gains 1 and its relative-position bias
tables normal(0, 1) (mmdet draws them at 0.02, which leaves each block's
branch a few percent of the residual stream); integer buffers (the bias
index) keep the module's values. An LSKNet backbone's layer scales are 1
(the source starts them at 1e-2) and each of its BNs (a module with a
``running_var``) is drawn far from the identity: gain and running mean
normal(0, 1), bias normal(0, 0.5), running variance 2 (``_BN_RULE``); at
1e-2, or with identity BNs, a comparison with a reference could not see
a branch or a BN left out. A ViT backbone's (one with a ``pos_embed``)
linears and convs draw their biases as their weights, normal(0,
fan_in^-1/2), the transposed conv's fan-in its input channels; its
``pos_embed`` is normal(0, 0.02) and its relative tables normal(0, 0.1)
(``_VIT_RULE``), where the source starts them at zero: a zero table would
hide a relative term left out. Its int8 activation ranges are 0, the
uncalibrated state: :func:`..models.quant.calibrate` fills them.
"""
import numpy as np
import torch

from ..models.retina_head import focal_bias

# an inference BN's leaves: ('normal', std) or ('fill', value)
_BN_RULE = {'weight': ('normal', 1.0), 'bias': ('normal', 0.5),
            'running_mean': ('normal', 1.0), 'running_var': ('fill', 2.0)}
# a ViT's position tables: leaf -> std
_VIT_RULE = {'pos_embed': 0.02, 'rel_pos_h': 0.1, 'rel_pos_w': 0.1}


def _fan_in(module, weight):
    """A linear's or conv's fan-in from its weight; a ViT pyramid's
    transposed conv (kernel = stride) takes one tap of each input
    channel."""
    if any(p.startswith('simfp_') for p in module.split('.')):
        return weight[0]
    return int(np.prod(weight[1:]))


def _is_stem_kernel(path):
    """The ResNet's own ``conv1/kernel`` (not a bottleneck's conv1)."""
    return path[-2:] == ('conv1', 'kernel') and (
        len(path) == 2 or not path[-3].startswith('layer'))


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if hasattr(value, 'items'):
            yield from _flatten(value, path)
        else:
            yield path, value


def from_flax(variables):
    """flax variables -> ``state_dict`` of f32 CPU tensors."""
    sd = {}
    for collection in ('params', 'batch_stats', 'quant_stats'):
        for path, leaf in _flatten(variables.get(collection, {})):
            arr = np.asarray(leaf, dtype=np.float32)
            module = '.'.join(path[:-1])
            if path[-1] == 'kernel' and not _is_stem_kernel(path):
                sd[f'{module}.weight'] = arr.transpose(3, 2, 0, 1)
            else:
                sd[f'{module}.{path[-1]}'] = arr
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in sd.items()}


def seeded_state_dict(model, seed):
    """A state dict for ``model`` drawn from ``numpy.random`` with
    ``seed``: the same seed gives the same weights on every machine."""
    rng = np.random.RandomState(seed)
    sd = {}
    state = model.state_dict()
    bns = {n.rpartition('.')[0] for n in state if n.endswith('.running_var')}
    # a ViT's prefix ('backbone.' in a detector), or None
    vit = next((n[:-len('pos_embed')] for n in state
                if n.rpartition('.')[2] == 'pos_embed'), None)
    for name, t in state.items():
        shape = tuple(t.shape)
        head = name.startswith(('bbox_head.', 'refine_head_', 'frm_'))
        module, _, leaf = name.rpartition('.')
        if not t.is_floating_point():
            sd[name] = t.detach().clone()
            continue
        if module in bns and leaf in _BN_RULE:
            kind, value = _BN_RULE[leaf]
            v = rng.normal(0.0, value, shape) if kind == 'normal' \
                else np.full(shape, value)
        elif leaf.startswith('layer_scale_'):
            v = np.ones(shape)
        elif vit is not None and leaf in _VIT_RULE:
            v = rng.normal(0.0, _VIT_RULE[leaf], shape)
        elif vit is not None and name.startswith(vit) and leaf == 'bias' \
                and state[f'{module}.weight'].dim() > 1:
            fan_in = _fan_in(module, tuple(state[f'{module}.weight'].shape))
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == 'kernel':                  # stem, HWIO
            fan_in = shape[0] * shape[1] * shape[2]
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == 'weight' and len(shape) == 1:      # LayerNorm gain
            v = np.ones(shape)
        elif leaf == 'weight':                  # conv OIHW, linear (O, I)
            fan_in = _fan_in(module, shape)
            v = rng.normal(0.0, 0.01 if head else fan_in ** -0.5, shape)
        elif leaf == 'relative_position_bias_table':
            v = rng.normal(0.0, 1.0, shape)
        elif name.endswith('retina_cls.bias'):
            v = np.full(shape, focal_bias())
        elif leaf in ('scale', 'var'):
            v = np.ones(shape)
        else:               # bias, mean; act_absmax, in_absmax uncalibrated
            v = np.zeros(shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    return sd
