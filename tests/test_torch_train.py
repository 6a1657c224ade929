"""The port's training slice against the JAX package, on the CPU in f32:
the losses, ``detector_loss`` stage by stage on JAX's own head outputs,
the whole model's losses and gradients against ``jax.value_and_grad``,
two SGD steps against JAX's ``make_train_step``, the LR schedule, the
clip, and the routes that have no backward.

The model is the tiny R3Det of tests/test_detector.py (depth 10, width 32,
one tower conv, 3 classes, 64^2 images), the same flax weights through
``from_flax`` (FrozenBN statistics and affines perturbed, the heads'
prediction layers scaled up so that the losses and their gradients are not
all at the focal prior). ``detector_loss`` on JAX's outputs runs op by op
(``jax.disable_jit``): compiled, XLA's CPU fusion contracts ``a * b + c``
into FMAs, which can round IoUs that tie at a gt's best anchor a last bit
apart and so assign such anchors otherwise (tests/test_torch_targets.py).
The whole-model comparisons run JAX compiled (op by op they take minutes);
on this scene the compiled targets equal the op-by-op ones, which the
losses' 1e-5 agreement checks.

Tolerances:
- losses: 1e-5 relative (f32; head outputs from convs summed in another
  order, the same targets);
- gradients: each parameter's within 1e-3 relative L2 of JAX's (f32 convs
  and their backward summed in other orders, through depth); frozen ones
  exactly zero;
- parameters after two SGD steps: each parameter tensor within 1e-3 of
  its update's size (L2 norms of ``p - p_jax`` against ``p_jax - p0``: the
  gradients' tolerance, carried through momentum) plus two f32 ulps of the
  parameter (the final ``p + u`` may round the other way; XLA may also
  contract the update's multiply-adds into FMAs).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from r3det_tpu.models import detectors as J
from r3det_tpu.models import losses as JL
from r3det_tpu.parallel import mesh as JM
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.models import losses as TL
from r3det_tpu_torch.parallel import train as TR
from r3det_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)

SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
J_CFG = J.DetectorConfig(
    num_classes=3, stacked_convs=1, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=J.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(J.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=J.TestCfg(nms_pre=64, max_per_img=16))
T_CFG = T.DetectorConfig(
    num_classes=3, stacked_convs=1, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=T.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(T.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=T.TestCfg(nms_pre=64, max_per_img=16))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
STEP_RTOL = 1e-3


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def make_batch(rng, b=2, size=64, g=4):
    """tests/test_detector.py::make_batch on its own generator."""
    images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    gt = np.zeros((b, g, 5), np.float32)
    labels = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        n = rng.randint(1, g + 1)
        gt[i, :n] = np.stack([
            rng.uniform(10, size - 10, n), rng.uniform(10, size - 10, n),
            rng.uniform(8, 24, n), rng.uniform(6, 16, n),
            rng.uniform(-math.pi / 2 + 0.05, -0.05, n)], -1)
        labels[i, :n] = rng.randint(0, 3, n)
        mask[i, :n] = True
    return dict(image=images, gt_bboxes=gt, gt_labels=labels, gt_mask=mask)


def perturb(tree, rng, path=()):
    """FrozenBN statistics and affines off the identity; the prediction
    layers scaled up."""
    out = {}
    for k, v in tree.items():
        p = path + (k,)
        if hasattr(v, 'items'):
            out[k] = perturb(v, rng, p)
        elif 'bn' in ''.join(p) and k in ('mean', 'bias'):
            out[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
        elif 'bn' in ''.join(p) and k in ('var', 'scale'):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == 'kernel' and p[-2] in ('retina_cls', 'retina_reg'):
            out[k] = np.asarray(v) * 30
        else:
            out[k] = np.array(v)
    return out


@pytest.fixture(scope='module')
def setup():
    rng = np.random.RandomState(0)
    batch = make_batch(rng)
    model = J.build_detector(J_CFG, dtype=jnp.float32)
    v = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch['image'])))
    v = perturb(v, rng)
    jbatch = {k: jnp.asarray(a) for k, a in batch.items()}
    return model, v, batch, jbatch


def port_model(v):
    m = T.build_detector(T_CFG, dtype=torch.float32, device='cpu')
    m.load_state_dict(from_flax(v), strict=True)
    return m


def tbatch(batch):
    return {k: t(a) for k, a in batch.items()}


def jax_loss_fn(model, batch_stats, jbatch):
    def loss_fn(params):
        out = model.apply({'params': params, 'batch_stats': batch_stats},
                          jbatch['image'])
        losses = J.detector_loss(out, J_CFG, SIZES, jbatch['gt_bboxes'],
                                 jbatch['gt_labels'], jbatch['gt_mask'])
        return losses['total'], losses
    return loss_fn


def assert_losses_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = float(w)
        assert abs(float(got[k]) - w) <= LOSS_RTOL * max(abs(w), 1e-3), \
            (k, float(got[k]), w)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['focal', 'bce', 'smooth_l1', 'l1'])
def test_losses_match_jax(name):
    rng = np.random.RandomState(1)
    n, c = 200, 4
    logits = rng.normal(0, 3, (n, c)).astype(np.float32)
    labels = rng.randint(0, c + 1, n).astype(np.int32)     # c: background
    w = rng.uniform(0, 2, n).astype(np.float32)
    pred = rng.normal(0, 1, (n, 5)).astype(np.float32)
    target = (pred + rng.normal(0, 0.2, (n, 5))).astype(np.float32)
    for avg in (37.0, 0.25):                         # max(avg_factor, 1)
        if name == 'focal':
            got = TL.sigmoid_focal_loss(t(logits), t(labels), t(w), c, avg)
            want = JL.sigmoid_focal_loss(logits, labels, w, c, avg)
        elif name == 'bce':
            got = TL.sigmoid_bce_loss(t(logits), t(labels), t(w), c, avg)
            want = JL.sigmoid_bce_loss(logits, labels, w, c, avg)
        elif name == 'smooth_l1':
            got = TL.smooth_l1_loss(t(pred), t(target), t(w), avg, beta=0.11)
            want = JL.smooth_l1_loss(pred, target, w, avg, beta=0.11)
        else:
            got = TL.l1_loss(t(pred), t(target), t(w), avg)
            want = JL.l1_loss(pred, target, w, avg)
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_detector_loss_on_jax_outputs_matches_jax(setup):
    """detector_loss on JAX's own head outputs and rois, stage by stage:
    the same targets, the same losses."""
    model, v, batch, jbatch = setup
    out = jax.jit(model.apply)(v, jbatch['image'])
    with jax.disable_jit():
        want = J.detector_loss(out, J_CFG, SIZES, jbatch['gt_bboxes'],
                               jbatch['gt_labels'], jbatch['gt_mask'])
    tout = jax.tree.map(lambda a: t(np.asarray(a)), out)
    b = tbatch(batch)
    got = T.detector_loss(tout, T_CFG, SIZES, b['gt_bboxes'], b['gt_labels'],
                          b['gt_mask'])
    assert set(got) == {'s0.loss_cls', 's0.loss_bbox', 'sr0.loss_cls',
                        'sr0.loss_bbox', 'total'}
    assert all(float(want[k]) > 0 for k in want)
    assert_losses_close(got, want)


@pytest.fixture(scope='module')
def jax_grads(setup):
    model, v, _, jbatch = setup
    loss_fn = jax_loss_fn(model, v['batch_stats'], jbatch)
    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v['params'])
    return losses, from_flax({'params': grads})


def test_losses_and_gradients_match_jax_value_and_grad(setup, jax_grads):
    _, v, batch, _ = setup
    want_losses, want_grads = jax_grads
    m = port_model(v)
    losses, grads = TR.loss_and_grads(m, T_CFG, SIZES, tbatch(batch))
    assert_losses_close(losses, want_losses)
    names = [n for n, _ in m.named_parameters()]
    assert set(names) == set(want_grads)
    for n, g in zip(names, grads):
        w = want_grads[n]
        if g is None:
            continue
        assert g.shape == w.shape, n
        err = float((g - w).norm())
        assert err <= GRAD_RTOL * float(w.norm()) + 1e-12, \
            (n, err, float(w.norm()))


def test_frozen_parameters_get_zero_gradients(setup, jax_grads):
    """The stem and stage 1 (frozen_stages=1) get no gradient in the port,
    zeros in JAX; the stages after them do get one."""
    _, v, batch, _ = setup
    _, want_grads = jax_grads
    m = port_model(v)
    _, grads = TR.loss_and_grads(m, T_CFG, SIZES, tbatch(batch))
    frozen = ('backbone.conv1.', 'backbone.bn1.', 'backbone.layer1_')
    for (n, _), g in zip(m.named_parameters(), grads):
        if n.startswith(frozen):
            assert g is None, n
            assert not want_grads[n].any(), n
        else:
            assert g is not None, n
    assert any(float(g.abs().max()) > 0 for (n, _), g in
               zip(m.named_parameters(), grads)
               if n.startswith('backbone.layer2_'))


def test_two_sgd_steps_match_jax_train_step(setup):
    """Two updates (so momentum counts) of the port's train step against
    JAX's make_train_step from the same parameters and batch: every
    parameter within STEP_RTOL of its update's size, the frozen ones
    decayed as JAX decays them."""
    model, v, batch, jbatch = setup
    jsched = JM.make_lr_schedule(base_lr=0.01, warmup_iters=2)
    tx = JM.make_optimizer(jsched)
    params = jax.tree.map(jnp.asarray, v['params'])
    state = JM.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=v['batch_stats'],
                          opt_state=tx.init(params), tx=tx)
    mesh = JM.make_mesh(jax.devices()[:1])
    jstep = JM.make_train_step(model, J_CFG, SIZES, mesh, donate=False)
    jlosses = []
    for _ in range(2):
        state, losses = jstep(state, jbatch)
        jlosses.append(losses)
    want = from_flax({'params': state.params})

    m = port_model(v)
    p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    opt = TR.make_optimizer(m.parameters(),
                            TR.make_lr_schedule(base_lr=0.01, warmup_iters=2))
    step = TR.make_train_step(m, T_CFG, SIZES, optimizer=opt, device='cpu')
    b = tbatch(batch)
    for i in range(2):
        assert_losses_close(step(b), jlosses[i])
    assert opt.count == 2
    moved = 0
    for n, p in m.named_parameters():
        upd = float((want[n] - p0[n]).norm())
        err = float((p.detach() - want[n]).norm())
        assert err <= STEP_RTOL * upd + 2.0 ** -22 * float(want[n].norm()), \
            (n, err, upd)
        moved += int(upd > 0)
    # every parameter moved: the frozen ones by their weight decay
    assert moved == len(want)


# ---------------------------------------------------------------------------
# the schedule and the clip
# ---------------------------------------------------------------------------

def test_lr_schedule_is_jax_schedule():
    """Exact (f32) at warmup's ends, its middle and around each decay
    boundary."""
    steps = (0, 1, 250, 499, 500, 501, 7999, 8000, 8001, 10999, 11000,
             11001, 20000)
    for kw in ({}, dict(base_lr=0.01, warmup_iters=2),
               dict(step_epochs=(3,), iters_per_epoch=7, gamma=0.5)):
        want = JM.make_lr_schedule(**kw)
        got = TR.make_lr_schedule(**kw)
        for s in steps:
            w = np.float32(want(jnp.int32(s)))
            assert got(s) == float(w), (kw, s, got(s), float(w))


@pytest.mark.parametrize('scale', [0.01, 1.0, 100.0])
def test_clip_matches_optax(scale):
    """Global norms below and above 35: optax's clip_by_global_norm."""
    rng = np.random.RandomState(int(scale * 100))
    grads = [rng.normal(0, scale, s).astype(np.float32)
             for s in ((3, 4), (17,), (2, 3, 5))]
    want, _ = optax.clip_by_global_norm(35.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = TR.clip_by_global_norm([t(g) for g in grads], 35.0)
    norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                         for g in grads))
    assert (norm >= 35.0) == (scale == 100.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


def test_train_step_needs_a_card_unless_asked_for_the_cpu():
    m = T.build_detector(T_CFG, dtype=torch.float32, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TR.make_train_step(m, T_CFG, SIZES)
    else:
        with pytest.raises(ValueError):
            TR.make_train_step(m, T_CFG, SIZES)
    TR.make_train_step(m, T_CFG, SIZES, device='cpu')


# ---------------------------------------------------------------------------
# routes without a backward
# ---------------------------------------------------------------------------

def test_fused_bottleneck_route_raises_under_autograd():
    from r3det_tpu_torch.models.resnet import Bottleneck
    m = Bottleneck(256, 64, fused=True)
    x = torch.randn(1, 256, 8, 8).contiguous(
        memory_format=torch.channels_last)
    assert m.can_fuse(x)
    with pytest.raises(RuntimeError, match='no backward'):
        m(x)
    with torch.no_grad():
        assert m(x).shape == x.shape


def test_stem_pool_route_raises_under_autograd():
    from r3det_tpu_torch.models.resnet import ResNet
    m = ResNet(depth=10, dtype=torch.bfloat16, stem_fused_kernel=False,
               stem_pool_kernel=True, frozen_stages=-1)
    x = torch.randn(1, 32, 32, 3)
    with pytest.raises(RuntimeError, match='no backward'):
        m(x)
    m.frozen_stages = 0            # the stem runs with gradients off
    m(x)


@pytest.mark.parametrize('quantize', [True, 'static'])
def test_int8_conv_route_raises_under_autograd(quantize):
    from r3det_tpu_torch.models.quant import QConv
    m = QConv(8, 8, 3, padding=1, static_scale=quantize == 'static')
    m.act_absmax.fill_(3.0)
    x = torch.randn(1, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match='no backward'):
        m(x)
    with pytest.raises(RuntimeError, match='no backward'):
        m.fused(x.permute(0, 2, 3, 1))
    with torch.no_grad():
        assert m(x).shape == x.shape


@pytest.mark.parametrize('frozen_stages', [-1, 0, 1])
def test_stem_gradient_follows_frozen_stages(frozen_stages):
    """frozen_stages < 0: the stem takes its plain form under autograd and
    gets a gradient; >= 0: none, and stage 1 gets one only when it is not
    frozen."""
    from r3det_tpu_torch.models.resnet import ResNet
    m = ResNet(depth=10, dtype=torch.float32, frozen_stages=frozen_stages)
    with torch.no_grad():
        m.conv1.kernel.normal_(0, 0.1)
    sum(o.sum() for o in m(torch.randn(1, 32, 32, 3))).backward()
    assert (m.conv1.kernel.grad is not None) == (frozen_stages < 0)
    assert (m.layer1_0.conv1.weight.grad is not None) == (frozen_stages < 1)
    assert m.layer2_0.conv1.weight.grad is not None
