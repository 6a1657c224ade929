"""The port's int8 serving configuration against the JAX package, on the CPU
in float32: a tiny R3Det (depth 14, so an identity block exists) with
``quantize='static'``, ``quantize_head='static'`` and ``int8_act``, the same
flax weights through ``from_flax``, the same numpy images.

What was found, and the tolerances that follow from it:

- Every int8 layer is exact on its own: given the JAX stage's inputs, the
  port's FPN, heads and FRM give the JAX outputs within 1e-5 of their
  largest magnitude, and calibrate to the same ``act_absmax`` within 1e-6.
- Through the whole network the two differ by whole int8 codes. XLA's CPU
  FrozenBN contracts ``x * inv + b`` into an FMA and its ``rsqrt`` rounds
  differently from PyTorch's, so values differ in the last f32 bit; where
  such a value lies at a .5 boundary of the int8 grid, its code flips, and
  the flip propagates. The ResNet stages stay within 2e-2 of their largest
  magnitude (one code is ~1/127 of a layer's range), the head maps within
  5e-2 of each stage's largest magnitude (the bound of
  ``tests/test_quant.py``), and calibrated ranges within 2e-2 relative.
- Detections from the same head outputs are identical; the whole predict
  step keeps the detections stated in ``test_predict_step_agrees``.
- The serving route of a bf16 model (each conv's FrozenBN, residual, ReLU
  and the next conv's quantize in one fused op) equals the unfused modules
  exactly: on the CPU it runs the fused op's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.models import detectors as J
from r3det_tpu_torch.models import detectors as T
from r3det_tpu_torch.models.quant import calibrate
from r3det_tpu_torch.models.resnet import Bottleneck
from r3det_tpu_torch.models.retina_head import RRetinaHead
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.convert import from_flax

torch.set_num_threads(2)

FEATMAP_SIZES = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))
CFG_KW = dict(num_classes=3, stacked_convs=2, feat_channels=32,
              backbone_depth=14, num_refine_stages=1, quantize='static',
              quantize_head='static')
J_CFG = J.DetectorConfig(
    stage_loss_weights=(1.0,), s0_train=J.StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(J.StageTrainCfg(0.6, 0.5, 0.0, None),),
    test=J.TestCfg(nms_pre=64, max_per_img=16), **CFG_KW)
T_CFG = T.DetectorConfig(test=T.TestCfg(nms_pre=64, max_per_img=16),
                         **CFG_KW)
STAGES = ('backbone', 'neck', 'bbox_head', 'frm_0', 'refine_head_0')


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def nchw(a):
    return t(a).permute(0, 3, 1, 2)


def rel(got, want, scale=None):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(scale, 1e-12))


@pytest.fixture(scope='module')
def jax_run():
    """JAX: init, one calibration pass (stage inputs and outputs captured),
    then the calibrated forward and predict."""
    rng = np.random.RandomState(0)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    model = J.build_detector(J_CFG, dtype=jnp.float32, int8_act=True)
    v = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(images)))
    for head in ('bbox_head', 'refine_head_0'):
        v['params'][head]['retina_cls']['kernel'] *= 100
        v['params'][head]['retina_reg']['kernel'] *= 30
    for name in ('conv_5_1', 'conv_1_5', 'conv_1_1'):
        v['params']['frm_0'][name]['kernel'] *= 30
    cal_out, mut = jax.jit(lambda var, x: model.apply(
        var, x, mutable=['quant_stats', 'intermediates'],
        capture_intermediates=lambda mdl, _: mdl.name in STAGES))(
            v, jnp.asarray(images))
    calibrated = dict(v, quant_stats=jax.tree.map(np.array,
                                                  mut['quant_stats']))
    out, st = jax.jit(lambda var, x: model.apply(
        var, x, capture_intermediates=lambda mdl, _: mdl.name in STAGES))(
            calibrated, jnp.asarray(images))
    dets = jax.jit(lambda o: J.detector_predict(o, J_CFG, FEATMAP_SIZES))(out)

    def stages(tree):
        return {k: tree['intermediates'][k]['__call__'][0] for k in STAGES}
    return dict(images=images, v=v, calibrated=calibrated, out=out,
                inter=stages(st), dets=dets, cal_inter=stages(mut),
                cal_rois=cal_out['rois'][0])


def port_model(variables, **kw):
    model = T.build_detector(T_CFG, dtype=torch.float32, int8_act=True,
                             device='cpu', **kw)
    model.load_state_dict(from_flax(variables), strict=True)
    return model


def quant_stats(module):
    return {k: float(v) for k, v in module.state_dict().items()
            if k.endswith(('act_absmax', 'in_absmax'))}


def test_build_options_reach_every_conv(jax_run):
    """The flags make the same convs int8 as in JAX (the state dict holds
    every quant_stats entry) and the final head convs stay float."""
    model = port_model(jax_run['v'])
    want = from_flax({'quant_stats': jax_run['v']['quant_stats']})
    assert set(quant_stats(model)) == set(want)
    assert type(model.bbox_head.retina_cls).__name__ == 'Conv2d'
    assert type(model.frm_0.conv_1_5).__name__ == 'QConv'
    assert model.backbone.layer1_1.int8_act


def test_stages_match_jax_given_jax_inputs(jax_run):
    """neck, heads and FRM, each fed the JAX stage's inputs."""
    model = port_model(jax_run['calibrated'])
    out, inter = jax_run['out'], jax_run['inter']
    with torch.no_grad():
        neck = model.neck([nchw(a) for a in inter['backbone']])
        for g, w in zip(neck, inter['neck']):
            assert rel(g.permute(0, 2, 3, 1).numpy(), w) <= 1e-5
        feats = [nchw(a) for a in inter['neck']]
        for g, w in zip(sum(model.bbox_head(feats), ()),
                        sum(out['s0'], ())):
            assert rel(g.numpy(), w) <= 1e-5
        frm = model.frm_0(feats, [t(r) for r in out['rois'][0]])
        for g, w in zip(frm, inter['frm_0']):
            assert rel(g.permute(0, 2, 3, 1).numpy(), w) <= 1e-5
        head = model.refine_head_0([nchw(a) for a in inter['frm_0']])
        for g, w in zip(sum(head, ()), sum(out['sr'][0], ())):
            assert rel(g.numpy(), w) <= 1e-5


def test_calibrate_matches_jax(jax_run):
    """Stage by stage on the JAX calibration pass's inputs: every range
    within 1e-6. The whole model from the images: within 2e-2 (code
    flips, see the module docstring)."""
    want = from_flax({'quant_stats': jax_run['calibrated']['quant_stats']})
    inter = jax_run['cal_inter']
    model = port_model(jax_run['v'])
    stage_inputs = {
        'neck': ([nchw(a) for a in inter['backbone']],),
        'bbox_head': ([nchw(a) for a in inter['neck']],),
        'frm_0': ([nchw(a) for a in inter['neck']],
                  [t(r) for r in jax_run['cal_rois']]),
        'refine_head_0': ([nchw(a) for a in inter['frm_0']],),
    }
    for name, args in stage_inputs.items():
        stage = getattr(model, name)

        class Stage(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.stage = stage

            def forward(self, batch):
                return self.stage(*batch)
        calibrate(Stage(), [args])
        got = quant_stats(stage)
        assert got
        for k, g in got.items():
            np.testing.assert_allclose(g, want[f'{name}.{k}'], rtol=1e-6,
                                       err_msg=k)
    whole = port_model(jax_run['v'])
    calibrate(whole, [t(jax_run['images'])])
    got = quant_stats(whole)
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=2e-2, err_msg=k)


@pytest.mark.parametrize('stem', ['fused', 'unfused', 'unfused_pool'])
def test_int8_model_matches_jax(jax_run, stem):
    """The calibrated int8 model from the images: backbone stages within
    2e-2, head maps and rois within 5e-2 of each stage's largest magnitude.
    JAX runs its unfused stem (its fused stem has no f32 form); the port's
    fused stem follows the kernel's single dequant factor."""
    kw = {'fused': dict(stem_fused_kernel=True),
          'unfused': dict(stem_fused_kernel=False),
          'unfused_pool': dict(stem_fused_kernel=False,
                               stem_pool_kernel=True)}[stem]
    model = port_model(jax_run['calibrated'], **kw)
    with torch.no_grad():
        c = model.backbone(t(jax_run['images']))
        got = model(t(jax_run['images']))
    for g, w in zip(c, jax_run['inter']['backbone']):
        assert rel(g.permute(0, 2, 3, 1).numpy(), w) <= 2e-2
    out = jax_run['out']
    for want_maps, got_maps in ((out['s0'], got['s0']),
                                (out['sr'][0], got['sr'][0])):
        for w_lvls, g_lvls in zip(want_maps, got_maps):
            scale = max(np.abs(np.asarray(w)).max() for w in w_lvls)
            for w, g in zip(w_lvls, g_lvls):
                assert tuple(g.shape) == w.shape
                assert rel(g.numpy(), w, scale) <= 5e-2
    # a roi is the best anchor's box: where a code flip changes which
    # anchor scores best, the whole roi changes
    w = np.concatenate([np.asarray(r) for r in out['rois'][0]], 1)
    g = torch.cat(got['rois'][0], 1).numpy()
    same = (np.abs(g - w) <= 5e-2 * np.abs(w).max()).all(-1)
    assert same.mean() >= 0.95, same.mean()


def test_predict_on_jax_head_outputs_matches_jax(jax_run):
    want = jax_run['dets']
    outs = jax.tree.map(lambda a: t(np.asarray(a)), jax_run['out'])
    dets, labels, num = T.detector_predict(outs, T_CFG, FEATMAP_SIZES)
    np.testing.assert_array_equal(num.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(dets.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)


def test_predict_step_agrees(jax_run):
    """The port's predict step on the images against JAX's detections: the
    same number per image within 1/8, and at least half of JAX's
    detections found with the same label and a box within 2%. Code flips
    move scores and boxes slightly (module docstring), and with 16
    detections kept of many near-tied candidates that reorders the tail:
    19 of 32 were found when this test was written."""
    want = [np.asarray(a) for a in jax_run['dets']]
    model = port_model(jax_run['calibrated'])
    step = make_predict_step(model, T_CFG, FEATMAP_SIZES)
    dets, labels, num = (a.numpy() for a in step(t(jax_run['images'])))
    assert dets.shape == want[0].shape and labels.shape == want[1].shape
    found = total = 0
    for i in range(dets.shape[0]):
        n = int(want[2][i])
        assert n > 0 and abs(int(num[i]) - n) <= max(1, n // 8)
        wd, wl = want[0][i, :n], want[1][i, :n]
        gd, gl = dets[i, :int(num[i])], labels[i, :int(num[i])]
        same = (wl[:, None] == gl[None]) & (
            np.abs(wd[:, None] - gd[None])
            <= 2e-2 * (np.abs(wd[:, None]) + 1)).all(-1)
        found += int(same.any(1).sum())
        total += n
    assert found >= 0.5 * total, (found, total)


def force_fused_routes(model, on):
    """Send every int8 Bottleneck and head tower through its fused route
    (on) or back to the route its conditions pick (off): on the CPU the
    fused route runs its plain version."""
    for m in model.modules():
        for cls, route in ((Bottleneck, 'q8_fused_route'),
                           (RRetinaHead, 'fused_route')):
            if isinstance(m, cls):
                if on:
                    setattr(m, route, lambda x: True)
                else:
                    m.__dict__.pop(route, None)


@pytest.fixture(scope='module')
def bf16_run(jax_run):
    """The calibrated int8 serving model in bf16 on the CPU, its unfused
    outputs and each fused-route module's inputs."""
    model = T.build_detector(T_CFG, dtype=torch.bfloat16, int8_act=True,
                             device='cpu')
    model.load_state_dict(from_flax(jax_run['calibrated']), strict=True)
    names = ('backbone.layer1_0', 'backbone.layer1_1', 'backbone.layer2_0',
             'bbox_head', 'refine_head_0')
    inputs = {}
    hooks = [model.get_submodule(n).register_forward_pre_hook(
        lambda m, a, n=n: inputs.setdefault(n, a)) for n in names]
    with torch.no_grad():
        out = model(t(jax_run['images']))
    for h in hooks:
        h.remove()
    return model, out, inputs


@pytest.mark.parametrize('name', ['backbone.layer1_0', 'backbone.layer1_1',
                                  'backbone.layer2_0', 'bbox_head',
                                  'refine_head_0'])
def test_fused_route_matches_unfused_module(bf16_run, name):
    """A downsample block, an int8_act identity block, a strided block and
    both heads: the fused route's plain version equals the module's
    unfused output bit for bit. The route is off on CPU tensors."""
    model, _, inputs = bf16_run
    module = model.get_submodule(name)
    args = inputs[name]
    x = args[0] if isinstance(module, Bottleneck) else args[0][0]
    route = module.q8_fused_route if isinstance(module, Bottleneck) \
        else module.fused_route
    assert x.dtype == torch.bfloat16 and not route(x)
    with torch.no_grad():
        want = module(*args)
        force_fused_routes(module, True)
        try:
            got = module(*args)
        finally:
            force_fused_routes(module, False)
    flat = (lambda o: list(o[0]) + list(o[1])) if isinstance(
        module, RRetinaHead) else (lambda o: [o])
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == w.shape and torch.equal(g, w)


def test_fused_model_matches_unfused_model(bf16_run, jax_run):
    """The whole bf16 int8 serving model with every fused route: the same
    head maps and rois as the unfused model, exactly."""
    model, want, _ = bf16_run
    force_fused_routes(model, True)
    try:
        with torch.no_grad():
            got = model(t(jax_run['images']))
    finally:
        force_fused_routes(model, False)
    for key in ('s0', 'sr', 'rois'):
        g, w = got[key], want[key]
        g, w = (g[0], w[0]) if key == 'sr' else (g, w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert torch.equal(a, b)
