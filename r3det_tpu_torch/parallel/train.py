"""Training on one card: the LR schedule, the optimizer and the train step.

Port of ``r3det_tpu/parallel/mesh.py:93-168`` for one device (data
parallelism comes later). It reproduces optax's arithmetic, not torch's
defaults:

- ``make_lr_schedule``: a linear warmup from ``base_lr * warmup_ratio``,
  then a step decay (optax's ``piecewise_constant_schedule``), each in f32
  in optax's order of operations, evaluated at the update count before
  the update (optax's ``count``);
- ``SGD`` (``make_optimizer``): ``clip_by_global_norm(35)`` first (``g *
  35 / |g|`` by ``(g / |g|) * 35`` when ``|g| >= 35``, no epsilon; torch's
  ``clip_grad_norm_`` adds 1e-6), then ``add_decayed_weights(1e-4)``, then
  SGD with momentum 0.9: ``trace = u + 0.9 * trace``, ``p = p + (-lr) *
  trace``. Like the JAX package it updates and decays every parameter,
  the frozen stem and stage 1 with their FrozenBN affines included: their
  gradients are zero (a parameter with no ``.grad`` counts as zero), not
  absent. mmdet freezes them with ``requires_grad=False`` and so does not
  decay them (ROADMAP F6).

``make_train_step`` returns ``step(batch) -> losses``: forward,
``detector_loss``, backward, the update. A stage with an RRandomSampler
draws from a ``torch.Generator`` seeded with the update count, as the JAX
step folds the global step into ``PRNGKey(0)`` (another stream; the same
role); stages without one draw nothing. It runs on the card and raises
without one unless the caller asks for the CPU (``device='cpu'``).
"""
import torch

from ..models.detectors import detector_loss


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def make_lr_schedule(base_lr=2.5e-3, warmup_iters=500, warmup_ratio=1.0 / 3.0,
                     step_epochs=(8, 11), iters_per_epoch=1000, gamma=0.1):
    """mmcv's StepLrUpdater with a linear warmup (schedule_1x): ``lr(step)``
    -> the learning rate, an f32 value as a Python float."""
    boundaries = sorted({int(e * iters_per_epoch): gamma
                         for e in step_epochs}.items())

    def schedule(step):
        if step < warmup_iters:
            warm = _f32(1 - warmup_ratio) * _f32(step)
            warm = _f32(warmup_ratio) + warm / _f32(max(warmup_iters, 1))
            return float(_f32(base_lr) * warm)
        v = _f32(base_lr)
        for threshold, scale in boundaries:
            ind = torch.clamp_min(torch.sign(torch.tensor(threshold - step))
                                  .float(), 0.0)
            v = v * ind + ((1 - ind) * _f32(scale)) * v
        return float(v)
    return schedule


def clip_by_global_norm(grads, max_norm):
    """optax's clip: every gradient times ``max_norm / |g|`` (as ``(g /
    |g|) * max_norm``) when the global L2 norm ``|g|`` reaches
    ``max_norm``, unchanged below it. No host sync."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class SGD:
    """optax's ``chain(clip_by_global_norm(clip_norm),
    add_decayed_weights(weight_decay), sgd(lr_schedule, momentum))`` over
    ``params``, by hand; ``step(grads)`` updates the parameters in place
    (``None`` gradients count as zeros)."""

    def __init__(self, params, lr_schedule, momentum=0.9, weight_decay=1e-4,
                 clip_norm=35.0):
        self.params = list(params)
        self.lr_schedule = lr_schedule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        grads = clip_by_global_norm(grads, self.clip_norm)
        neg_lr = -self.lr_schedule(self.count)
        for p, g, t in zip(self.params, grads, self.trace):
            u = g + self.weight_decay * p
            t.mul_(self.momentum).add_(u)
            p.add_(t * neg_lr)
        self.count += 1


def make_optimizer(params, lr_schedule=None, momentum=0.9,
                   weight_decay=1e-4, clip_norm=35.0):
    """The shipped optimizer (schedule_1x) over ``params``."""
    return SGD(params, lr_schedule or make_lr_schedule(), momentum,
               weight_decay, clip_norm)


def loss_and_grads(model, cfg, featmap_sizes, batch, generator=None):
    """Forward, ``detector_loss`` and backward on ``batch`` (a dict of
    tensors: 'image' NHWC, 'gt_bboxes', 'gt_labels', 'gt_mask'). Returns
    the detached loss dict and the gradients of ``model.parameters()`` in
    order (``None`` where a parameter got none: the frozen ones)."""
    model.zero_grad(set_to_none=True)
    out = model(batch['image'])
    losses = detector_loss(out, cfg, featmap_sizes, batch['gt_bboxes'],
                           batch['gt_labels'], batch['gt_mask'],
                           generator=generator, kernels=model.kernels)
    losses['total'].backward()
    return ({k: v.detach() for k, v in losses.items()},
            [p.grad for p in model.parameters()])


def make_train_step(model, cfg, featmap_sizes, optimizer=None,
                    device='cuda'):
    """``step(batch) -> losses``: one SGD update of ``model`` (by
    ``optimizer``, the shipped one by default) on ``batch``, the batch's
    tensors on the model's device. The model must lie on ``device``, the
    card by default (it raises without one)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("make_train_step: no CUDA card; pass "
                           "device='cpu' to train on the CPU")
    param_dev = next(model.parameters()).device
    if param_dev.type != device.type:
        raise ValueError(f'the model lies on {param_dev}, not on {device}')
    opt = optimizer or make_optimizer(model.parameters())

    def step(batch):
        gen = torch.Generator(param_dev).manual_seed(opt.count)
        losses, grads = loss_and_grads(model, cfg, featmap_sizes, batch, gen)
        opt.step(grads)
        return losses
    return step
