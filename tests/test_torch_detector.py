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
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.convert import from_flax

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
    dets, labels, num, (live, branch) = T.detector_predict(
        to_torch(slice_run['want']), T_CFG, FEATMAP_SIZES,
        return_branch=True)
    assert branch == slice_run['branch'], live
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
    with pytest.raises(NotImplementedError):
        T.build_detector(T_CFG._replace(hbb_anchors=True), device='cpu')
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
