"""Checkpoints (``torch.save``) and the torchvision ResNet converter.

Port of ``r3det_tpu/utils/checkpoint.py``, with ``torch.save`` files where
the JAX package writes orbax directories:

- ``save_checkpoint`` / ``restore_checkpoint``: the model's state dict,
  the optimizer's momentum (``SGD.trace``) and update count
  (``SGD.count``, which the LR schedule and the sampler's generator read)
  and the step, restored in place bit for bit;
- ``publish_checkpoint``: the state dict alone, the file name suffixed
  with the first 8 hex digits of a sha256 over its tensors (the
  reference's publish_model);
- ``convert_torch_resnet`` / ``load_pretrained_backbone``: a torchvision
  ResNet state dict (``torchvision://resnet50``, the configs' init) in the
  port's ``ResNet`` names: OIHW convs as they are, the 7x7 stem folded
  into the space-to-depth stem's (4, 4, 12, 64) kernel, FrozenBN
  ``scale`` / ``bias`` / ``mean`` / ``var``.
"""
import hashlib
import os
import os.path as osp

import numpy as np
import torch

from ..models.resnet import STAGE_BLOCKS, fold_stem_kernel


def save_checkpoint(ckpt_dir, step, model, optimizer):
    """Write ``ckpt_dir/step_<step>.pt``; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.abspath(osp.join(ckpt_dir, f'step_{step}.pt'))
    payload = {'step': int(step),
               'state_dict': {k: v.detach().cpu()
                              for k, v in model.state_dict().items()},
               'trace': [t.detach().cpu() for t in optimizer.trace],
               'count': int(optimizer.count)}
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path, model, optimizer):
    """Load ``path`` into ``model`` and ``optimizer`` in place (each
    tensor keeps its device and dtype); returns the saved step."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    model.load_state_dict(payload['state_dict'])
    if len(payload['trace']) != len(optimizer.trace):
        raise ValueError(f'{path}: {len(payload["trace"])} momentum '
                         f'tensors for {len(optimizer.trace)} parameters')
    with torch.no_grad():
        for t, saved in zip(optimizer.trace, payload['trace']):
            t.copy_(saved)
    optimizer.count = payload['count']
    return payload['step']


def publish_checkpoint(in_path, out_path):
    """Strip the optimizer state and append a content hash to the file
    name (``out-<sha256[:8]>.pt``); returns the published path."""
    payload = torch.load(in_path, map_location='cpu', weights_only=True)
    slim = {'state_dict': payload['state_dict']}
    h = hashlib.sha256()
    for k in sorted(slim['state_dict']):
        h.update(k.encode())
        h.update(slim['state_dict'][k].contiguous().numpy().tobytes())
    root, ext = osp.splitext(osp.abspath(out_path))
    final = f'{root}-{h.hexdigest()[:8]}{ext or ".pt"}'
    torch.save(slim, final)
    return final


def load_state_dict_file(path):
    """A torchvision-style state dict from a ``.npz`` or a ``torch.save``
    file (its ``state_dict`` entry where it has one)."""
    if path.endswith('.npz'):
        with np.load(path) as f:
            return dict(f)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return sd.get('state_dict', sd)


def convert_torch_resnet(state_dict, depth=50, stem_space_to_depth=True):
    """torchvision ResNet state dict -> the port's ``ResNet`` state dict
    (f32 CPU tensors, keys relative to the backbone). Takes any mapping of
    names to tensors or arrays."""
    def arr(k):
        v = state_dict[k]
        if hasattr(v, 'detach'):
            v = v.detach().cpu().numpy()
        return np.asarray(v, np.float32)

    sd = {}

    def bn(dst, src):
        for a, b in (('scale', 'weight'), ('bias', 'bias'),
                     ('mean', 'running_mean'), ('var', 'running_var')):
            sd[f'{dst}.{a}'] = arr(f'{src}.{b}')

    w7 = arr('conv1.weight').transpose(2, 3, 1, 0)          # HWIO
    sd['conv1.kernel'] = fold_stem_kernel(w7) if stem_space_to_depth \
        else w7
    bn('bn1', 'bn1')
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        for b in range(n):
            src = f'layer{stage + 1}.{b}'
            dst = f'layer{stage + 1}_{b}'
            for i in (1, 2, 3):
                sd[f'{dst}.conv{i}.weight'] = arr(f'{src}.conv{i}.weight')
                bn(f'{dst}.bn{i}', f'{src}.bn{i}')
            if f'{src}.downsample.0.weight' in state_dict:
                sd[f'{dst}.downsample_conv.weight'] = arr(
                    f'{src}.downsample.0.weight')
                bn(f'{dst}.downsample_bn', f'{src}.downsample.1')
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def load_pretrained_backbone(model, state_dict, depth=50,
                             stem_space_to_depth=True):
    """Copy converted torchvision weights into ``model.backbone`` in place
    (each tensor keeps its device and dtype). Every converted tensor must
    name a backbone tensor of its shape."""
    converted = convert_torch_resnet(state_dict, depth, stem_space_to_depth)
    own = model.backbone.state_dict()
    for k, v in converted.items():
        if k not in own or own[k].shape != v.shape:
            raise ValueError(f'pretrained backbone tensor {k} '
                             f'{tuple(v.shape)} has no counterpart of its '
                             'shape in the model')
    with torch.no_grad():
        for k, v in converted.items():
            own[k].copy_(v)
    return model
