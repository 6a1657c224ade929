"""The port's Swin backbone (``r3det_tpu_torch/models/swin.py``) and rotated
RetinaNet on it, in float32 on the CPU, held to the benchmark's plain
reference (``portbench/reference/backbones/swin.py``, mmdet's
``SwinTransformer`` written out) on seeded weights at a small size: embed
32, depths (2, 2, 2, 2), heads (1, 2, 4, 8), window 7, on 100 x 100 images,
whose stages are 25, 13, 7 and 4 tokens a side (padded to 28, 14, 7 and 7:
padding, none, and a stage smaller than its window). Four planted faults
each miss the tolerance by far. Then the port's helpers: the seeded
weights, the config builder's mmdet dict, the ResNet-only options, the
spans, the kept bias and the dry run's Swin build.
"""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench.bench import check, common
from portbench.reference import predict as rpred
from portbench.reference.model import Detector
from r3det_tpu_torch.models import swin
from r3det_tpu_torch.models.detectors import (R3DET_R50_V1, DetectorConfig,
                                              build_detector)
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.builder import build_from_config
from r3det_tpu_torch.utils.convert import seeded_state_dict

from program_spans import traced

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(swin_embed_dims=32, swin_depths=[2, 2, 2, 2],
             swin_num_heads=[1, 2, 4, 8], feat_channels=32,
             compute_dtype='float32')
# The port and the reference make the same float32 operations in the same
# order but for a few sums (the port adds the bias and the mask in one
# tensor, merges patches by a reshape): their outputs differ by float32
# summation order, ~1e-7 relative an op. A relative norm of 1e-5 leaves
# that a hundredfold room; each planted fault reads ~0.5.
TOL = 1e-5


def small_config():
    cfg = json.loads((ROOT / 'portbench' / 'configs' /
                      'rretinanet_obb_swin_t.json').read_text())
    cfg.update(SMALL)
    cfg['test'] = dict(cfg['test'], nms_pre=200)
    return cfg


@pytest.fixture(scope='module')
def pair():
    """The reference detector and the seeded state, the config."""
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


def images(h=100, w=100, seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, h, w, 3, generator=g) * 4 - 2


def backbone_err(model, ref, x):
    with torch.no_grad():
        got, want = model.backbone(x), ref.backbone(x)
    assert [t.shape for t in got] == [t.shape for t in want]
    return max(check.rel_err([a], [b]) for a, b in zip(got, want))


@pytest.mark.parametrize('hw', [(100, 100), (60, 100)])
def test_backbone_matches_reference(pair, hw):
    cfg, ref, state = pair
    model = program(cfg, state)
    x = images(*hw)
    assert backbone_err(model, ref, x) < TOL
    with torch.no_grad():
        shapes = [tuple(t.shape) for t in model.backbone(x)]
    h, w = hw
    side = [(-(-h // s), -(-w // s)) for s in (8, 16, 32)]
    assert shapes == [(2, c) + s for c, s in zip((64, 128, 256), side)]


def _pad_masked(h, w, window, shift, device):
    """The fault: keys on the padding masked out as well."""
    hp, wp = swin.padded(h, window), swin.padded(w, window)
    valid = torch.zeros(1, hp, wp, 1, device=device)
    valid[:, :h, :w] = 1
    if shift:
        valid = swin.cyclic_shift(valid, -shift)
    keys = swin.window_partition(valid, window).view(-1, 1, window * window)
    pad = torch.where(keys == 0, swin.MASK_VALUE, 0.0).expand(
        -1, window * window, -1)
    base = _ATTN_MASK(h, w, window, shift, device)
    return pad if base is None else pad + base


_ATTN_MASK = swin.attn_mask
FAULTS = {
    'mask_dropped': ('attn_mask', lambda *a: None),
    'roll_sign_flipped': ('cyclic_shift',
                          lambda x, s: torch.roll(x, (-s, -s), (1, 2))),
    'padding_masked': ('attn_mask', _pad_masked),
    'index_transposed': None,
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_planted_fault_misses_the_tolerance(pair, fault, monkeypatch):
    cfg, ref, state = pair
    if FAULTS[fault]:
        monkeypatch.setattr(swin, *FAULTS[fault])
    model = program(cfg, state)
    if fault == 'index_transposed':
        for m in model.modules():
            if isinstance(m, swin.WindowMSA):
                m.relative_position_index = \
                    m.relative_position_index.T.contiguous()
    assert backbone_err(model, ref, images()) > 10 * TOL


def test_predict_step_matches_reference(pair):
    """The port's predict step on rotated RetinaNet Swin: head outputs
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


def test_bias_is_made_once_and_follows_the_table(pair):
    cfg, _, state = pair
    model = program(cfg, state)
    msa = model.backbone.stages[0].blocks[1].attn.w_msa
    with torch.no_grad():
        model.backbone(images())
        first = msa.bias(25, 25, 3, torch.float32, torch.device('cpu'))
        assert first.shape == (16, 1, 49, 49)
        model.backbone(images(seed=1))
        assert msa.bias(25, 25, 3, torch.float32,
                        torch.device('cpu')) is first
        msa.relative_position_bias_table.add_(1.0)
        again = msa.bias(25, 25, 3, torch.float32, torch.device('cpu'))
    assert again is not first
    torch.testing.assert_close(again, first + 1.0)
    plain = model.backbone.stages[0].blocks[0].attn.w_msa
    with torch.no_grad():
        assert plain.bias(25, 25, 0, torch.float32,
                          torch.device('cpu')).shape == (1, 1, 49, 49)


def test_mask_and_index_are_mmdets():
    """Mask regions and the index against a hand count: window 7, shift
    3, a 14 x 14 map (four windows); the index is symmetric in its
    offsets, 84 = (6, 6) on the diagonal."""
    m = swin.attn_mask(14, 14, 7, 3, torch.device('cpu'))
    assert m.shape == (4, 49, 49)
    assert not m[0].any()                       # the top-left window
    # the bottom-right window: rows 0-3 / 4-6 by 7 - 3, columns alike
    region = torch.tensor([(r >= 4) * 3 + (c >= 4) for r in range(7)
                           for c in range(7)])
    want = torch.where(region[None, :] != region[:, None], -100.0, 0.0)
    assert torch.equal(m[3], want)
    idx = swin.relative_position_index(7)
    assert idx.shape == (49, 49) and idx.dtype == torch.int64
    assert bool((idx.diagonal() == 84).all())
    assert int(idx[0, 48]) == 0 and int(idx[48, 0]) == 168
    assert int(idx.max()) == 168


def test_spans_on_the_cpu(pair):
    cfg, _, state = pair
    model = program(cfg, state)
    with torch.no_grad():
        _, spans = traced(lambda: model.backbone(images()))
    names = [n for n, _, _ in spans]
    assert {n: names.count(n) for n in set(names)} == {
        'r3det.backbone.swin.embed': 1, 'r3det.backbone.swin.attn': 8,
        'r3det.backbone.swin.mlp': 8, 'r3det.backbone.swin.merge': 3}
    with torch.no_grad():
        _, spans = traced(lambda: model.backbone(images()), on=False)
    assert spans == []


@pytest.mark.parametrize('option', [
    {'quantize': True}, {'quantize_head': 'static'}, {'int8_act': True},
    {'stem_fused_kernel': False}, {'stem_pool_kernel': True},
    {'fused_blocks': True}])
def test_resnet_only_options_raise(option):
    cfg = DetectorConfig(backbone='swin', swin_embed_dims=32,
                         swin_num_heads=(1, 2, 4, 8), feat_channels=32)
    fields = {k: v for k, v in option.items() if k in cfg._fields}
    kwargs = {k: v for k, v in option.items() if k not in cfg._fields}
    with pytest.raises(ValueError, match='ResNet-only'):
        build_detector(cfg._replace(**fields), dtype=torch.float32,
                       device='cpu', **kwargs)


def test_unknown_backbone_raises():
    with pytest.raises(ValueError, match='not provided'):
        build_detector(DetectorConfig(backbone='vit'), device='cpu')


def _digest(sd):
    h = hashlib.sha256()
    for n, t in sd.items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_seeded_state_dict_draws_swin_and_keeps_r50():
    torch.set_num_threads(2)
    model = build_detector(DetectorConfig(backbone='swin'),
                           dtype=torch.float32, device='cpu')
    sd = seeded_state_dict(model, 0)
    assert model.load_state_dict(sd).missing_keys == []
    built = model.state_dict()
    for name, t in sd.items():
        if not name.startswith('backbone.'):
            continue
        leaf = name.rsplit('.', 1)[-1]
        if leaf == 'relative_position_index':
            assert t.dtype == torch.int64 and torch.equal(t, built[name])
        elif leaf == 'relative_position_bias_table':
            assert float(t.std()) == pytest.approx(1.0, rel=0.2)
        elif leaf == 'weight' and t.dim() == 1:
            assert torch.equal(t, torch.ones_like(t))
        elif leaf == 'weight':
            fan = t[0].numel()
            assert float(t.std()) == pytest.approx(fan ** -0.5, rel=0.1)
        else:
            assert leaf == 'bias' and not t.any()
    # unchanged for ResNet: the sha256 of the names and bytes before Swin
    r50 = build_detector(R3DET_R50_V1, dtype=torch.float32, device='cpu')
    assert _digest(seeded_state_dict(r50, 0)) == \
        '3d2ff369af7ba4a66723fe60ffb5a7535b37622b7a7c2afb6c5852fcbdc5260f'


def _swin_model_dict(**backbone):
    from r3det_tpu_torch.dryrun import SWIN_T_RRETINANET
    d = json.loads(json.dumps(SWIN_T_RRETINANET))
    d['backbone'].update(embed_dims=32, num_heads=[1, 2, 4, 8], **backbone)
    d['neck']['in_channels'] = [64, 128, 256]
    d['bbox_head'].update(feat_channels=32, in_channels=32)
    return d


def test_builder_maps_the_mmdet_swin_dict():
    model, cfg = build_from_config({'model': _swin_model_dict()},
                                   dtype=torch.float32, device='cpu')
    assert cfg.backbone == 'swin'
    assert (cfg.swin_embed_dims, cfg.swin_depths, cfg.swin_num_heads,
            cfg.swin_window_size, cfg.swin_mlp_ratio, cfg.swin_patch_size,
            cfg.swin_out_indices) == (32, (2, 2, 6, 2), (1, 2, 4, 8), 7, 4,
                                      4, (1, 2, 3))
    assert cfg.loss_bbox_type == 'l1'
    hash(cfg)
    assert isinstance(model.backbone, swin.SwinTransformer)
    assert [getattr(model.neck, f'lateral_{i}').in_channels
            for i in range(3)] == [64, 128, 256]
    assert model.neck.extra_0.in_channels == 256
    d = _swin_model_dict()
    d['neck']['in_channels'] = [32, 64, 128, 256]
    with pytest.raises(ValueError, match='in_channels'):
        build_from_config({'model': d}, dtype=torch.float32, device='cpu')
    d['neck']['start_level'] = 1
    assert build_from_config({'model': d}, dtype=torch.float32,
                             device='cpu')[1].backbone == 'swin'
    for bad in ({'qkv_bias': False}, {'use_abs_pos_embed': True},
                {'strides': (4, 2, 2, 1)}):
        with pytest.raises(NotImplementedError):
            build_from_config({'model': _swin_model_dict(**bad)},
                              dtype=torch.float32, device='cpu')


def test_print_config_shows_the_fields_the_backbone_reads():
    from r3det_tpu_torch.tools.print_config import derived_fields
    from r3det_tpu_torch.utils.builder import detector_config_from_dict
    got = derived_fields(detector_config_from_dict(_swin_model_dict()))
    assert got['backbone'] == 'swin' and got['swin_embed_dims'] == 32
    assert 'backbone_depth' not in got and 'frozen_stages' not in got
    got = derived_fields(R3DET_R50_V1)
    assert got['backbone_depth'] == 50
    assert not [k for k in got if k.startswith(('swin_', 'backbone'))
                and k != 'backbone_depth']


def test_dry_run_builds_the_swin_config():
    from r3det_tpu_torch.dryrun import entry
    torch.set_num_threads(2)
    fn, (x,) = entry(device='cpu', backbone='swin')
    sums = fn(x)
    assert len(sums) == 10
    assert all(s.dim() == 0 and bool(torch.isfinite(s)) for s in sums)
