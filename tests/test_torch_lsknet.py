"""The port's LSKNet backbone (``r3det_tpu_torch/models/lsknet.py``) and
rotated RetinaNet on it, in float32 on the CPU, held to the benchmark's
plain reference (``portbench/reference/backbones/lsknet.py``, mmrotate's
``LSKNet`` written out) on seeded weights at small widths: embed 16, 32,
40 and 64, depths (1, 1, 2, 1), MLP ratios (8, 8, 4, 4), on images of 96
x 80 and 70 x 70 (stages of 24 x 20 down to 3 x 3, and odd sides). Then
the port's helpers: the state dict's names, the spans, the ResNet-only
options, the kept BN affine, the seeded weights (LSKNet's BNs and layer
scales; ResNet's and Swin's draws unchanged), the config builder's
mmrotate dict and the dry run's LSKNet build.
"""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench.bench import check, common
from portbench.reference import predict as rpred
from portbench.reference.model import Detector
from r3det_tpu_torch.models import lsknet
from r3det_tpu_torch.models.detectors import (R3DET_R50_V1, DetectorConfig,
                                              build_detector)
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.builder import build_from_config
from r3det_tpu_torch.utils.convert import seeded_state_dict

from program_spans import traced

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(lsk_embed_dims=[16, 32, 40, 64], lsk_depths=[1, 1, 2, 1],
             lsk_mlp_ratios=[8, 8, 4, 4], feat_channels=32,
             compute_dtype='float32')
# The port and the reference make the same float32 operations but for a
# few orders and folds: BN folded to a scale and a shift, the selection's
# channel sums split in two, the taps in channels_last; their outputs
# differ by float32 rounding, ~3e-7 relative. 1e-5 leaves thirtyfold
# room; a BN or a branch left out reads ~0.1 or more.
TOL = 1e-5


def small_config(**over):
    cfg = json.loads((ROOT / 'portbench' / 'configs' /
                      'rretinanet_obb_lsknet_s.json').read_text())
    cfg.update(SMALL, **over)
    cfg['test'] = dict(cfg['test'], nms_pre=200)
    return cfg


@pytest.fixture(scope='module')
def pair():
    """The config, the reference detector and the seeded state."""
    torch.set_num_threads(2)
    cfg = small_config()
    ref = Detector(cfg)
    state = common.seeded_state(ref, 5, torch.device('cpu'))
    ref.load_state_dict(state)
    return cfg, ref, state


def program(cfg, state):
    model = build_detector(common.program_config(cfg), dtype=torch.float32,
                           device='cpu')
    model.load_state_dict(state)
    return model


def images(h=96, w=80, seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, h, w, 3, generator=g) * 4 - 2


@pytest.mark.parametrize('hw', [(96, 80), (70, 70)])
def test_backbone_matches_reference(pair, hw):
    cfg, ref, state = pair
    model = program(cfg, state)
    x = images(*hw)
    with torch.no_grad():
        got, want = model.backbone(x), ref.backbone(x)
    assert [t.shape for t in got] == [t.shape for t in want]
    for a, b in zip(got, want):
        assert check.rel_err([a], [b]) < TOL
        assert a.is_contiguous(memory_format=torch.channels_last)
    h, w = hw
    sides = [((h - 1) // 4 + 1, (w - 1) // 4 + 1)]
    for _ in range(3):
        sides.append(((sides[-1][0] - 1) // 2 + 1,
                      (sides[-1][1] - 1) // 2 + 1))
    assert [tuple(t.shape) for t in got] == [
        (2, c) + s for c, s in zip((16, 32, 40, 64), sides)]
    assert model.backbone.out_channels == ref.backbone.out_channels


def test_state_dict_names_are_the_references(pair):
    cfg, ref, state = pair
    model = program(cfg, state)
    names = list(model.backbone.state_dict())
    assert names == list(ref.backbone.state_dict())
    assert 'block1.0.attn.spatial_gating_unit.conv_spatial.weight' in names
    assert 'block3.1.mlp.dwconv.dwconv.bias' in names
    assert 'patch_embed2.norm.running_var' in names
    assert 'norm4.weight' in names and 'block2.0.layer_scale_2' in names
    sgu = model.backbone.block1[0].attn.spatial_gating_unit
    assert (sgu.conv_spatial.dilation, sgu.conv_spatial.padding,
            sgu.conv_spatial.groups) == ((3, 3), (9, 9), 16)
    assert model.backbone.norm1.eps == 1e-6
    assert model.backbone.block1[0].norm1.eps == 1e-5


def test_detector_forward_and_predict_match_reference(pair):
    """The port's predict step on rotated RetinaNet LSKNet: head outputs
    within the tolerance, and the same detections (``det_mismatch`` 0) as
    the reference's decode and NMS on the reference's outputs."""
    cfg, ref, state = pair
    size = 128
    x = images(size, size, seed=2)
    state = dict(state)
    common.shape_cls(state, ref, cfg, x,
                     [{'layer': 'bbox_head.retina_cls', 'live': 60}])
    model = program(cfg, state)
    sizes = common.featmap_sizes(cfg, size)
    step = make_predict_step(model, common.program_config(cfg), sizes,
                             img_shape=(size, size))
    with torch.no_grad():
        got, want = model(x)['s0'], ref(x)
        dets = step(x)
        kept, sel = rpred.predict(want, cfg, sizes, (size, size))
    for a, b in zip(got[0] + got[1], want['s0'][0] + want['s0'][1]):
        assert check.rel_err([a], [b]) < TOL
    assert min(int(v) for v in sel[3]) > 20
    assert check.det_mismatch(dets, kept) == 0.0
    ref.load_state_dict(pair[2])


def test_spans_on_the_cpu():
    """LSKNet-S's depths (2, 2, 4, 2) at small widths: 4 embed, 10 attn,
    10 mlp and 4 norm ranges a forward, nested in no other; none with the
    spans off."""
    torch.set_num_threads(2)
    cfg = small_config(lsk_depths=[2, 2, 4, 2])
    model = build_detector(common.program_config(cfg), dtype=torch.float32,
                           device='cpu')
    with torch.no_grad():
        _, spans = traced(lambda: model.backbone(images(64, 64)))
    names = [n for n, _, _ in spans]
    assert {n: names.count(n) for n in set(names)} == {
        'r3det.backbone.lsk.embed': 4, 'r3det.backbone.lsk.attn': 10,
        'r3det.backbone.lsk.mlp': 10, 'r3det.backbone.lsk.norm': 4}
    ends = [e for _, _, e in spans]
    assert all(s >= e for s, e in zip([s for _, s, _ in spans][1:], ends))
    with torch.no_grad():
        _, spans = traced(lambda: model.backbone(images(64, 64)), on=False)
    assert spans == []


@pytest.mark.parametrize('option', [
    {'quantize': True}, {'quantize_head': 'static'}, {'int8_act': True},
    {'stem_fused_kernel': False}, {'stem_pool_kernel': True},
    {'fused_blocks': True}])
def test_resnet_only_options_raise(option):
    cfg = DetectorConfig(backbone='lsknet', lsk_embed_dims=(16, 32, 40, 64),
                         feat_channels=32)
    fields = {k: v for k, v in option.items() if k in cfg._fields}
    kwargs = {k: v for k, v in option.items() if k not in cfg._fields}
    with pytest.raises(ValueError, match="ResNet-only.*'lsknet'"):
        build_detector(cfg._replace(**fields), dtype=torch.float32,
                       device='cpu', **kwargs)


def test_bn_affine_is_kept_and_follows_the_weights(pair):
    cfg, _, state = pair
    bn = program(cfg, state).backbone.block2[0].norm1
    x = torch.randn(2, 32, 8, 8, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        first = bn.affine(torch.float32)
        assert bn.affine(torch.float32) is first
        want = (x - bn.running_mean.view(1, -1, 1, 1)) / torch.sqrt(
            bn.running_var.view(1, -1, 1, 1) + 1e-5) \
            * bn.weight.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)
        torch.testing.assert_close(bn(x), want)
        bn.running_var.mul_(4.0)
        again = bn.affine(torch.float32)
    assert again is not first
    # rsqrt(4 v + eps) against rsqrt(v + eps) / 2: eps moves it by 2e-6
    torch.testing.assert_close(again[0], first[0] / 2, rtol=1e-5, atol=0)
    with torch.no_grad():
        assert bn.affine(torch.bfloat16)[0].dtype == torch.bfloat16


def _digest(sd):
    h = hashlib.sha256()
    for n, t in sd.items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_seeded_state_dict_draws_lsknet_far_from_identity():
    """Every BN of the LSKNet is drawn away from the identity (gains and
    means spread, variances 2), every layer scale is 1, the convs
    lecun-normal, the LayerNorms at (1, 0)."""
    torch.set_num_threads(2)
    cfg = common.program_config(small_config())
    model = build_detector(cfg, dtype=torch.float32, device='cpu')
    sd = seeded_state_dict(model, 0)
    assert model.load_state_dict(sd).missing_keys == []
    kinds = set()
    for name, t in sd.items():
        if not name.startswith('backbone.'):
            continue
        parts = name.split('.')
        leaf = parts[-1]
        if leaf == 'num_batches_tracked':
            assert t.dtype == torch.long
            kinds.add('count')
        elif leaf.startswith('layer_scale_'):
            assert torch.equal(t, torch.ones_like(t))
            kinds.add('layer_scale')
        elif len(parts) == 3 and parts[1].startswith('norm'):
            assert bool((t == (1.0 if leaf == 'weight' else 0.0)).all())
            kinds.add('layernorm')
        elif leaf == 'running_var':
            assert bool((t == 2.0).all())
            kinds.add('bn')
        elif leaf in ('running_mean', 'weight', 'bias') and t.dim() == 1 \
                and parts[-2].startswith('norm'):
            assert float(t.std()) > 0.3 and float(t.abs().max()) > 0.5
        elif leaf == 'weight':
            fan = t[0].numel()
            assert float(t.std()) == pytest.approx(fan ** -0.5, rel=0.35)
            kinds.add('conv')
        else:
            assert leaf == 'bias' and not t.any()
    assert kinds == {'count', 'layer_scale', 'layernorm', 'bn', 'conv'}


@pytest.mark.parametrize('cfg,want', [
    (R3DET_R50_V1,
     '3d2ff369af7ba4a66723fe60ffb5a7535b37622b7a7c2afb6c5852fcbdc5260f'),
    (DetectorConfig(backbone='swin'),
     'e7d5b74da250fa2b59c2178a3c6f7ffd236fd6241e84425816578325e2a22ee2')],
    ids=['r50', 'swin_t'])
def test_seeded_state_dict_keeps_resnet_and_swin(cfg, want):
    """The sha256 of the names and bytes, as they were before the BN and
    layer-scale rule."""
    torch.set_num_threads(2)
    model = build_detector(cfg, dtype=torch.float32, device='cpu')
    assert _digest(seeded_state_dict(model, 0)) == want


def _lsk_model_dict(**backbone):
    from r3det_tpu_torch.dryrun import LSKNET_S_RRETINANET
    d = json.loads(json.dumps(LSKNET_S_RRETINANET))
    d['backbone'].update(embed_dims=[16, 32, 40, 64], **backbone)
    d['neck']['in_channels'] = [16, 32, 40, 64]
    d['bbox_head'].update(feat_channels=32, in_channels=32)
    return d


def test_builder_maps_the_mmrotate_lsknet_dict():
    model, cfg = build_from_config({'model': _lsk_model_dict()},
                                   dtype=torch.float32, device='cpu')
    assert cfg.backbone == 'lsknet'
    assert (cfg.lsk_embed_dims, cfg.lsk_depths, cfg.lsk_mlp_ratios) == (
        (16, 32, 40, 64), (2, 2, 4, 2), (8, 8, 4, 4))
    assert cfg.loss_bbox_type == 'l1'
    hash(cfg)
    assert isinstance(model.backbone, lsknet.LSKNet)
    assert [getattr(model.neck, f'lateral_{i}').in_channels
            for i in range(3)] == [32, 40, 64]
    assert model.neck.extra_0.in_channels == 64
    # the class's mlp_ratios when the dict has none
    d = _lsk_model_dict()
    del d['backbone']['mlp_ratios']
    d['backbone'].update(depths=[1, 1, 2, 1], img_size=1024,
                         init_cfg=None, pretrained=None)
    assert build_from_config({'model': d}, dtype=torch.float32,
                             device='cpu')[1].lsk_mlp_ratios == (8, 8, 4, 4)
    d['neck']['start_level'] = 0
    with pytest.raises(ValueError, match='in_channels'):
        build_from_config({'model': d}, dtype=torch.float32, device='cpu')
    with pytest.raises(ValueError, match='one a stage'):
        build_from_config({'model': _lsk_model_dict(num_stages=3)},
                          dtype=torch.float32, device='cpu')
    with pytest.raises(NotImplementedError):
        build_from_config({'model': _lsk_model_dict(in_chans=4)},
                          dtype=torch.float32, device='cpu')


def test_print_config_shows_the_fields_the_backbone_reads():
    from r3det_tpu_torch.tools.print_config import derived_fields
    from r3det_tpu_torch.utils.builder import detector_config_from_dict
    got = derived_fields(detector_config_from_dict(_lsk_model_dict()))
    assert got['backbone'] == 'lsknet'
    assert got['lsk_embed_dims'] == (16, 32, 40, 64)
    assert not [k for k in got if k.startswith('swin_')]
    assert 'backbone_depth' not in got and 'frozen_stages' not in got
    for cfg in (R3DET_R50_V1, DetectorConfig(backbone='swin')):
        assert not [k for k in derived_fields(cfg) if k.startswith('lsk_')]


def test_dry_run_builds_the_lsknet_config():
    from r3det_tpu_torch.dryrun import entry
    torch.set_num_threads(2)
    fn, (x,) = entry(device='cpu', backbone='lsknet')
    sums = fn(x)
    assert len(sums) == 10
    assert all(s.dim() == 0 and bool(torch.isfinite(s)) for s in sums)


def test_dilated_taps_run_on_nchw_strides(pair, monkeypatch):
    """In a model moved to channels_last as on the card, ``conv_spatial``
    gets its input and weight with NCHW strides (PyTorch's depthwise
    kernel, not cuDNN's channels_last one) and hands channels_last on; the
    other convs keep channels_last."""
    cfg, ref, state = pair
    model = program(cfg, state).to(memory_format=torch.channels_last)
    x = images()
    with torch.no_grad():
        want = ref.backbone(x)
    seen = []
    real = torch.nn.Conv2d._conv_forward

    def spy(self, x, w, b):
        seen.append((self, x, w))
        return real(self, x, w, b)
    monkeypatch.setattr(torch.nn.Conv2d, '_conv_forward', spy)
    with torch.no_grad():
        got = model.backbone(x)
    for a, b in zip(got, want):
        assert check.rel_err([a], [b]) < TOL

    def nchw(t):
        return t.stride() == torch.empty(t.shape).stride()
    spatial = [(x, w) for m, x, w in seen if m.dilation == (3, 3)]
    assert len(spatial) == 5
    assert all(nchw(x) and nchw(w) for x, w in spatial)
    others = [x for m, x, _ in seen if m.dilation == (1, 1) and m.groups > 1]
    assert others and all(
        x.is_contiguous(memory_format=torch.channels_last) for x in others)
