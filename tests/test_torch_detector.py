"""The port's whole serving slice against the JAX package, on the CPU in
float32: R3Det at the size of tests/test_detector.py with stacked_convs=2,
the same flax weights through ``from_flax``, the same numpy images.

Tolerances: head maps, rois and FRM outputs within 1e-4 of each tensor's
largest magnitude (f32 convs summed in another order); detections from the
same head outputs identical in labels and count and within 1e-5 in value
(decode arithmetic only).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.models import detectors as J
from r3det_tpu_torch.core import coders
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.convert import from_flax

from program_spans import sweep_branch, traced

torch.set_num_threads(2)

FEATMAP_SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
J_CFG = J.DetectorConfig(
    num_classes=3, stacked_convs=2, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=J.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(J.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=J.TestCfg(nms_pre=64, max_per_img=16))
T_CFG = T.DetectorConfig(
    num_classes=3, stacked_convs=2, feat_channels=32, backbone_depth=10,
    num_refine_stages=1, test=T.TestCfg(nms_pre=64, max_per_img=16))
# refine-head cls bias shift per NMS budget branch: 'big' sends more live
# candidates than small_k = 64 to the sweep, 'small' fewer
BIAS_SHIFT = {'big': 4.0, 'small': -3.5}


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def to_torch(tree):
    return jax.tree.map(lambda a: t(np.asarray(a)), tree)


@pytest.fixture(scope='module')
def jax_model():
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    model = J.build_detector(J_CFG, dtype=jnp.float32)
    v = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    for head in ('bbox_head', 'refine_head_0'):
        v['params'][head]['retina_cls']['kernel'] *= 100
        v['params'][head]['retina_reg']['kernel'] *= 30
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        v['params']['frm_0'][name]['kernel'] *= 30
    apply = jax.jit(lambda var, x: model.apply(
        var, x, capture_intermediates=lambda mdl, _: mdl.name == 'frm_0'))
    predict = jax.jit(lambda out: J.detector_predict(out, J_CFG,
                                                     FEATMAP_SIZES))
    return images, v, apply, predict


@pytest.fixture(scope='module', params=list(BIAS_SHIFT))
def slice_run(request, jax_model):
    images, v, apply, predict = jax_model
    v = jax.tree.map(np.array, v)
    v['params']['refine_head_0']['retina_cls']['bias'] += \
        BIAS_SHIFT[request.param]
    out, state = apply(v, jnp.asarray(images))
    frm = state['intermediates']['frm_0']['__call__'][0]
    want_dets = predict(out)

    model = T.build_detector(T_CFG, dtype=torch.float32, device='cpu')
    model.load_state_dict(from_flax(v), strict=True)
    captured = {}
    model.frm_0.register_forward_hook(
        lambda m, i, o: captured.__setitem__('frm', o))
    with torch.no_grad():
        got = model(t(images))
    return dict(branch=request.param, images=images, model=model,
                want=out, want_frm=frm, want_dets=want_dets, got=got,
                got_frm=captured['frm'])


def assert_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


def test_slice_head_maps_rois_and_frm_match_jax(slice_run):
    want, got = slice_run['want'], slice_run['got']
    for stage_want, stage_got in ((want['s0'], got['s0']),
                                  (want['sr'][0], got['sr'][0])):
        for w_lvls, g_lvls in zip(stage_want, stage_got):
            for w, g in zip(w_lvls, g_lvls):
                assert tuple(g.shape) == w.shape
                assert_close(g.numpy(), w)
    for w, g in zip(want['rois'][0], got['rois'][0]):
        assert tuple(g.shape) == w.shape
        assert_close(g.numpy(), w)
    for w, g in zip(slice_run['want_frm'], slice_run['got_frm']):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w)


def test_predict_on_jax_head_outputs_matches_jax(slice_run):
    """detector_predict fed JAX's own head outputs gives JAX's detections,
    on both branches of the adaptive NMS budget."""
    want = slice_run['want_dets']
    (dets, labels, num), spans = traced(lambda: T.detector_predict(
        to_torch(slice_run['want']), T_CFG, FEATMAP_SIZES))
    assert sweep_branch(spans) == [slice_run['branch']], spans
    np.testing.assert_array_equal(num.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    assert (num.numpy() > 0).all()


def test_predict_step_matches_jax(slice_run):
    """The port's predict step on the images (forward + predict)."""
    want = slice_run['want_dets']
    step = make_predict_step(slice_run['model'], T_CFG, FEATMAP_SIZES)
    dets, labels, num = step(t(slice_run['images']))
    assert tuple(dets.shape) == (2, 16, 6)
    assert tuple(labels.shape) == (2, 16) and tuple(num.shape) == (2,)
    np.testing.assert_array_equal(num.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(want[0]), rtol=1e-4,
                               atol=1e-3)


def test_kernel_route_switch_is_identical_on_cpu(slice_run):
    """On CPU tensors the kernel wrappers take the plain versions, so the
    model gives the same result with its kernels switched off."""
    model = slice_run['model']
    images = t(slice_run['images'])
    with torch.no_grad():
        a = model(images)
        T.use_kernels(model, False)
        try:
            b = model(images)
        finally:
            T.use_kernels(model, True)
    for x, y in zip(a['sr'][0][0] + a['sr'][0][1],
                    b['sr'][0][0] + b['sr'][0][1]):
        assert torch.equal(x, y)


def test_unported_options_raise():
    """``hbb_anchors`` is ported (the model builds with the HBB coder);
    the TPU-only ``approx_topk`` still raises."""
    model = T.build_detector(T_CFG._replace(hbb_anchors=True), device='cpu')
    assert isinstance(model.cfg.coder(), coders.DeltaXYWHAHBBoxCoder)
    with pytest.raises(NotImplementedError):
        T.detector_predict({'sr': [((), ())], 'rois': [()]},
                           T_CFG._replace(test=T.TestCfg(approx_topk=True)),
                           FEATMAP_SIZES)


def test_import_leaves_jax_out():
    code = ('import sys\n'
            'import r3det_tpu_torch, r3det_tpu_torch._ext\n'
            'import r3det_tpu_torch.models.detectors\n'
            'import r3det_tpu_torch.models.quant\n'
            'import r3det_tpu_torch.ops.bottleneck_fuse\n'
            'import r3det_tpu_torch.parallel.predict\n'
            'import r3det_tpu_torch.parallel.train\n'
            'import r3det_tpu_torch.core.targets\n'
            'import r3det_tpu_torch.core.rtransforms\n'
            'import r3det_tpu_torch.core.coders\n'
            'import r3det_tpu_torch.core.iou_calculators\n'
            'import r3det_tpu_torch.ops.nms\n'
            'import r3det_tpu_torch.ops.convex\n'
            'import r3det_tpu_torch.datasets.synthetic\n'
            'import r3det_tpu_torch.utils.convert\n'
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "r3det_tpu")]\n'
            'assert not bad, bad\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, '-c', code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_sources_import_no_jax():
    """No source of the port imports jax, flax or anything of r3det_tpu
    (the JAX package), not even its numpy-only modules."""
    import re
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), 'r3det_tpu_torch')
    bad = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|optax|'
                     r'r3det_tpu)(\.|\s|$)', re.M)
    found = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(dirpath, f)) as fh:
                    found += [(f, m.group(0).strip())
                              for m in bad.finditer(fh.read())]
    assert not found, found


# ---------------------------------------------------------------------------
# horizontal base anchors (hbb_anchors, the HBB coder)
# ---------------------------------------------------------------------------

HBB_SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
HBB_CASES = {
    # RRetinaNet HBB: circumscribed assignment in the angle version, L1
    'rretinanet': dict(num_refine_stages=0, loss_bbox_type='l1'),
    # R3Det: circumscribed s0, a rotated refine stage on the rois
    'r3det': dict(num_refine_stages=1, stage_loss_weights=(1.0,)),
}


def hbb_cfgs(case):
    kw = dict(num_classes=3, stacked_convs=1, feat_channels=32,
              backbone_depth=10, hbb_anchors=True, **HBB_CASES[case])
    j = J.DetectorConfig(
        s0_train=J.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
        sr_train=(J.StageTrainCfg(0.6, 0.5, 0.0, None),) *
        kw['num_refine_stages'], test=J.TestCfg(nms_pre=64, max_per_img=16),
        **kw)
    tc = T.DetectorConfig(
        s0_train=T.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
        sr_train=(T.StageTrainCfg(0.6, 0.5, 0.0, None),) *
        kw['num_refine_stages'], test=T.TestCfg(nms_pre=64, max_per_img=16),
        **kw)
    return j, tc


def hbb_batch(rng, b=2, size=64, g=4):
    """v1 ground truth (tests/test_torch_train.py::make_batch)."""
    gt = np.zeros((b, g, 5), np.float32)
    labels = np.zeros((b, g), np.int32)
    mask = np.zeros((b, g), bool)
    for i in range(b):
        n = rng.randint(1, g + 1)
        gt[i, :n] = np.stack([
            rng.uniform(10, size - 10, n), rng.uniform(10, size - 10, n),
            rng.uniform(8, 24, n), rng.uniform(6, 16, n),
            rng.uniform(-np.pi / 2 + 0.05, -0.05, n)], -1)
        labels[i, :n] = rng.randint(0, 3, n)
        mask[i, :n] = True
    return gt, labels, mask


@pytest.fixture(scope='module', params=list(HBB_CASES))
def hbb_run(request):
    """The tiny f32 model with hbb_anchors: JAX's outputs, and the port's
    on the same converted weights."""
    j_cfg, t_cfg = hbb_cfgs(request.param)
    rng = np.random.RandomState(3)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    model = J.build_detector(j_cfg, dtype=jnp.float32)
    v = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    heads = ['bbox_head'] + ['refine_head_0'] * (j_cfg.num_refine_stages > 0)
    for head in heads:
        v['params'][head]['retina_cls']['kernel'] *= 30
        v['params'][head]['retina_reg']['kernel'] *= 30
    out = jax.jit(model.apply)(v, jnp.asarray(images))
    port = T.build_detector(t_cfg, dtype=torch.float32, device='cpu')
    port.load_state_dict(from_flax(v), strict=True)
    with torch.no_grad():
        got = port(t(images))
    return dict(case=request.param, j_cfg=j_cfg, t_cfg=t_cfg, out=out,
                got=got, batch=hbb_batch(rng))


def test_hbb_anchor_forward_matches_jax_and_pins_f9(hbb_run):
    """F9: JAX's forward hands the HBB coder the (cx, cy, w, h, a) grid
    anchors without the xyxy conversion, which reads them as (x1, y1, x2,
    y2): a roi decoded from zero deltas is w - cx wide. The port follows
    it: its rois equal JAX's."""
    want, got = hbb_run['out'], hbb_run['got']
    for w_lvls, g_lvls in zip(want['s0'], got['s0']):
        for w, g in zip(w_lvls, g_lvls):
            assert_close(g.numpy(), w)
    if hbb_run['case'] != 'r3det':
        return
    for w, g in zip(want['rois'][0], got['rois'][0]):
        assert_close(g.numpy(), w)
    j_cfg, t_cfg = hbb_run['j_cfg'], hbb_run['t_cfg']
    anchors = J.level_anchors(j_cfg, HBB_SIZES)
    rng = np.random.RandomState(4)
    cls = [rng.normal(0, 1, (2, h, w, 9 * 3)).astype(np.float32)
           for h, w in HBB_SIZES]
    reg = [np.zeros((2, h, w, 9 * 5), np.float32) for h, w in HBB_SIZES]
    j_rois = J.filter_bboxes([jnp.asarray(c) for c in cls],
                             [jnp.asarray(r) for r in reg], anchors,
                             j_cfg.coder(), j_cfg)
    t_rois = T.filter_bboxes([t(c) for c in cls], [t(r) for r in reg],
                             [t(np.asarray(a)) for a in anchors],
                             t_cfg.coder(), t_cfg)
    for lvl, (jr, tr) in enumerate(zip(j_rois, t_rois)):
        jr = np.asarray(jr)
        np.testing.assert_allclose(tr.numpy(), jr, rtol=1e-6, atol=1e-6)
        a = np.asarray(anchors[lvl]).reshape(-1, 9, 5)
        best = cls[lvl].reshape(2, -1, 9, 3).max(-1).argmax(-1)
        anc = np.take_along_axis(a[None], best[..., None, None], 2)[:, :, 0]
        np.testing.assert_allclose(jr[..., 2], anc[..., 2] - anc[..., 0],
                                   rtol=1e-6, atol=1e-6)


def test_hbb_anchor_detector_loss_matches_jax(hbb_run):
    """detector_loss with hbb_anchors on JAX's own head outputs: the
    losses within 1e-5 and their gradients with respect to every head
    output within 1e-3 (relative L2) of JAX's. R3Det's refine stage
    encodes against F9's rois, some of them of negative width, so its
    bbox loss is NaN in JAX: the port gives NaN in the same loss and the
    same gradient entries (ROADMAP.md Queue 3, F9)."""
    j_cfg, t_cfg, out = hbb_run['j_cfg'], hbb_run['t_cfg'], hbb_run['out']
    gt, labels, mask = hbb_run['batch']
    heads = {k: out[k] for k in ('s0', 'sr') if k in out}

    def j_loss(h):
        losses = J.detector_loss(dict(out, **h), j_cfg, HBB_SIZES,
                                 jnp.asarray(gt), jnp.asarray(labels),
                                 jnp.asarray(mask))
        return losses['total'], losses
    (_, want), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        heads)
    t_heads = jax.tree.map(lambda a: t(np.asarray(a)).requires_grad_(),
                           heads)
    t_out = dict(to_torch(out), **t_heads)
    got = T.detector_loss(t_out, t_cfg, HBB_SIZES, t(gt), t(labels), t(mask))
    got['total'].backward()
    assert set(got) == set(want)
    nan = {k for k, w in want.items() if np.isnan(float(w))}
    assert nan == ({'sr0.loss_bbox', 'total'} if hbb_run['case'] == 'r3det'
                   else set()), nan
    for k, w in want.items():
        g, w = got[k].item(), float(w)
        if k in nan:
            assert np.isnan(g), (k, g)
            continue
        assert w > 0 and abs(g - w) <= 1e-5 * max(abs(w), 1e-3), (k, g, w)
    for g, w in zip(jax.tree.leaves(t_heads), jax.tree.leaves(j_grads)):
        g, w = g.grad.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        err = np.linalg.norm(g[ok] - w[ok]) / max(np.linalg.norm(w[ok]),
                                                  1e-12)
        assert err <= 1e-3, err
