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
index) keep the module's values. Its int8 activation ranges are 0, the
uncalibrated state: :func:`..models.quant.calibrate` fills them.
"""
import numpy as np
import torch

from ..models.retina_head import focal_bias

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
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        head = name.startswith(('bbox_head.', 'refine_head_', 'frm_'))
        leaf = name.rsplit('.', 1)[-1]
        if not t.is_floating_point():
            sd[name] = t.detach().clone()
            continue
        if leaf == 'kernel':                    # stem, HWIO
            fan_in = shape[0] * shape[1] * shape[2]
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == 'weight' and len(shape) == 1:      # LayerNorm gain
            v = np.ones(shape)
        elif leaf == 'weight':                  # conv OIHW, linear (O, I)
            fan_in = int(np.prod(shape[1:]))
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
