"""The port's ViT backbone (``r3det_tpu_torch/models/vitdet.py``) and
rotated RetinaNet on it, in float32 on the CPU, held to the benchmark's
plain reference (``portbench/reference/backbones/vitdet.py``, detectron2's
``ViT`` written out) on seeded weights at a small size: embed 96, 3 heads
of 32, depth 4 with global blocks 1 and 3, window 4, on 160^2 images (a
10 x 10 grid, which window 4 pads to 12: the unmasked pad) and 128^2 ones
(an 8 x 8 grid: the global blocks' tables, built for 10 x 10, resized).
Then the bf16 route against the float32 port, the relative-table resize
against ``get_rel_pos``'s formula on a hand-made table, the kept tables,
the state dict's names, the spans, the ResNet-only options, the Swin
kernels' refusal of ViT's windows, the seeded weights, the config
builder's ``ViT`` dict, the config printer and the dry run's ViT build.
"""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from portbench.bench import check, common
from portbench.reference import predict as rpred
from portbench.reference.model import Detector
from r3det_tpu_torch.models import vitdet
from r3det_tpu_torch.models.detectors import (R3DET_R50_V1, DetectorConfig,
                                              build_detector)
from r3det_tpu_torch.ops import swin_attn
from r3det_tpu_torch.parallel.predict import make_predict_step
from r3det_tpu_torch.utils.builder import build_from_config
from r3det_tpu_torch.utils.convert import seeded_state_dict

from program_spans import traced

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vit_embed_dim=96, vit_num_heads=3, vit_depth=4,
             vit_global_blocks=[1, 3], vit_window_size=4, vit_img_size=160,
             feat_channels=32, compute_dtype='float32')
# The port and the reference make the same float32 operations but for
# their order: the port's attention is one fused call on q and k widened
# by the relative terms and one-hot key columns, the reference's the
# logits, the two terms, softmax and P.v written out. Their outputs
# differ by float32 rounding, ~5e-7 relative; 1e-5 leaves twentyfold
# room, and a relative term, the pad or a global block gone wrong reads
# 0.1 or more.
TOL = 1e-5


def small_config(**over):
    cfg = json.loads((ROOT / 'portbench' / 'configs' /
                      'rretinanet_obb_vitdet_b.json').read_text())
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


def program(cfg, state, dtype=torch.float32):
    model = build_detector(common.program_config(cfg), dtype=dtype,
                           device='cpu')
    model.load_state_dict(state, strict=True)
    return model


def images(h=160, w=None, seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, h, w or h, 3, generator=g) * 4 - 2


@pytest.mark.parametrize('size', [160, 128])
def test_backbone_matches_reference(pair, size):
    cfg, ref, state = pair
    model = program(cfg, state)
    x = images(size)
    with torch.no_grad():
        got, want = model.backbone(x), ref.backbone(x)
    grid = size // 16
    assert [tuple(t.shape) for t in got] == [
        (2, 48, 2 * grid, 2 * grid), (2, 96, grid, grid),
        (2, 96, grid // 2, grid // 2)]
    for a, b in zip(got, want):
        assert check.rel_err([a], [b]) < TOL
        assert a.is_contiguous(memory_format=torch.channels_last)
    assert model.backbone.out_channels == ref.backbone.out_channels
    with torch.no_grad():
        assert check.rel_err(model.neck(got), ref.neck(want)) < TOL


def test_state_dict_loads_under_detectron2_names(pair):
    cfg, ref, state = pair
    model = program(cfg, state)            # strict=True
    names = list(model.backbone.state_dict())
    assert names == list(ref.backbone.state_dict())
    for name in ('patch_embed.proj.weight', 'pos_embed',
                 'blocks.0.norm1.weight', 'blocks.0.attn.qkv.bias',
                 'blocks.1.attn.rel_pos_h', 'blocks.2.attn.rel_pos_w',
                 'blocks.3.attn.proj.weight', 'blocks.3.norm2.bias',
                 'blocks.2.mlp.fc1.weight', 'blocks.2.mlp.fc2.bias',
                 'simfp_3.0.weight', 'simfp_3.0.bias'):
        assert name in names
    sd = model.backbone.state_dict()
    assert tuple(sd['pos_embed'].shape) == (1, 197, 96)
    # window blocks' tables for 4 x 4, the global blocks' for 10 x 10
    assert [tuple(sd[f'blocks.{i}.attn.rel_pos_h'].shape)
            for i in range(4)] == [(7, 32), (19, 32), (7, 32), (19, 32)]
    assert tuple(sd['simfp_3.0.weight'].shape) == (96, 48, 2, 2)
    assert model.backbone.blocks[0].norm1.eps == 1e-6
    assert [b.window for b in model.backbone.blocks] == [4, 0, 4, 0]


def test_detector_forward_and_predict_match_reference(pair):
    """The port's predict step on rotated RetinaNet ViT: head outputs
    within the tolerance, and the same detections (``det_mismatch`` 0) as
    the reference's decode and NMS on the reference's outputs."""
    cfg, ref, state = pair
    size = 160
    x = images(size, seed=2)
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


def test_bf16_route_near_the_float32_port(pair):
    """The same module in bf16 against itself in float32: each level
    within 3% (relative norm). bf16 stores every activation, the q, k and
    v, the relative bias and P to 2^-9, and the residual stream carries
    the rounding through four blocks (the CPU reads 0.72-1.03% a level on
    three seeds); the reference with every product in fp8 reads 7.9-11%
    and misses the bound."""
    cfg, ref, state = pair
    lo, hi = program(cfg, state, torch.bfloat16), program(cfg, state)
    x = images()
    with torch.no_grad():
        got, want = lo.backbone(x), hi.backbone(x)
        low = check.quantized(ref.backbone, 'fp8', x)
    for a, b, c in zip(got, want, low):
        assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
        assert check.rel_err([a], [b]) < 0.03
        assert check.rel_err([c], [b]) > 0.03


def _get_rel_pos(q, k, table):
    """detectron2's ``get_rel_pos``, by hand: linear resize (align_corners
    False: row i reads at (i + 1/2) L / n - 1/2, clamped to the ends),
    then row q_i max(k/q, 1) - k_j max(q/k, 1) + (k - 1) max(q/k, 1)."""
    n, length = 2 * max(q, k) - 1, table.shape[0]
    if length != n:
        rows = []
        for i in range(n):
            src = min(max((i + 0.5) * length / n - 0.5, 0.0), length - 1)
            lo = int(src)
            hi = min(lo + 1, length - 1)
            rows.append(table[lo] * (1 - (src - lo)) + table[hi] * (src - lo))
        table = torch.stack(rows)
    out = torch.empty(q, k, table.shape[1])
    for i in range(q):
        for j in range(k):
            r = i * max(k / q, 1.0) - j * max(q / k, 1.0) \
                + (k - 1) * max(q / k, 1.0)
            out[i, j] = table[int(r)]
    return out


@pytest.mark.parametrize('q,k,rows', [(4, 4, 7), (6, 6, 7), (3, 3, 9),
                                      (2, 4, 9), (5, 3, 9)])
def test_rel_pos_resize_matches_get_rel_pos(q, k, rows):
    """A table of ``rows`` hand-made rows (row r is r, r^2 / 10 and -r)
    at a grid it was not built for, and at its own (4 x 4 for 7 rows)."""
    r = torch.arange(rows, dtype=torch.float32)
    table = torch.stack([r, r * r / 10, -r], 1)
    torch.testing.assert_close(vitdet.rel_pos(table, q, k),
                               _get_rel_pos(q, k, table), rtol=1e-6,
                               atol=1e-6)


def test_tables_are_kept_and_follow_the_weights(pair):
    cfg, _, state = pair
    net = program(cfg, state).backbone
    att = net.blocks[1].attn
    with torch.no_grad():
        first = att.rel_tables(8, 8, torch.float32)
        assert att.rel_tables(8, 8, torch.float32) is first
        assert att.rel_tables(10, 10, torch.float32) is not first
        pos = net.abs_pos(8, 8, torch.float32)
        assert net.abs_pos(8, 8, torch.float32) is pos
        att.rel_pos_h.mul_(2.0)
        net.pos_embed.mul_(2.0)
        again = att.rel_tables(10, 10, torch.float32)
        torch.testing.assert_close(again[0], 2 * vitdet.rel_pos(
            att.rel_pos_h / 2, 10, 10))
        torch.testing.assert_close(net.abs_pos(8, 8, torch.float32), 2 * pos)
        # at the pretrain grid's own size the table is not resized
        grid = net.pos_embed[0, 1:].view(14, 14, -1)
        assert torch.equal(net.abs_pos(14, 14, torch.float32)[0], grid)


def test_spans_on_the_cpu():
    """ViT-B's block pattern (depth 12, global blocks 2, 5, 8, 11) at a
    small width: 1 embed, 8 window, 4 global, 12 mlp and 1 pyramid range
    a forward, nested in no other; none with the spans off."""
    torch.set_num_threads(2)
    cfg = small_config(vit_depth=12, vit_global_blocks=[2, 5, 8, 11])
    model = build_detector(common.program_config(cfg), dtype=torch.float32,
                           device='cpu')
    with torch.no_grad():
        _, spans = traced(lambda: model.backbone(images(64)))
    names = [n for n, _, _ in spans]
    assert {n: names.count(n) for n in set(names)} == {
        'r3det.backbone.vit.embed': 1, 'r3det.backbone.vit.window_attn': 8,
        'r3det.backbone.vit.global_attn': 4, 'r3det.backbone.vit.mlp': 12,
        'r3det.backbone.vit.pyramid': 1}
    ends = [e for _, _, e in spans]
    assert all(s >= e for s, e in zip([s for _, s, _ in spans][1:], ends))
    with torch.no_grad():
        _, spans = traced(lambda: model.backbone(images(64)), on=False)
    assert spans == []


@pytest.mark.parametrize('option', [
    {'quantize': True}, {'quantize_head': 'static'}, {'int8_act': True},
    {'stem_fused_kernel': False}, {'stem_pool_kernel': True},
    {'fused_blocks': True}])
def test_resnet_only_options_raise(option):
    cfg = DetectorConfig(backbone='vitdet', vit_embed_dim=96,
                         vit_num_heads=3, vit_depth=2, feat_channels=32)
    fields = {k: v for k, v in option.items() if k in cfg._fields}
    kwargs = {k: v for k, v in option.items() if k not in cfg._fields}
    with pytest.raises(ValueError, match="ResNet-only.*'vitdet'"):
        build_detector(cfg._replace(**fields), dtype=torch.float32,
                       device='cpu', **kwargs)


def test_swin_kernels_refuse_vit_windows():
    """``ops/swin_attn.py``'s contract refuses ViT-B's windows on its
    widths (head_dim 64) and on its window (14^2 = 196 tokens), whatever
    the device, so they take plain PyTorch; Swin-T's windows it takes."""
    def why(dims, heads, window):
        return swin_attn._windows(dims, heads, window)
    assert 'head_dim 32, not 64' in why(768, 12, 14)
    assert 'window**2 <= 64, not 14**2' in why(384, 12, 14)
    assert why(96, 3, 7) is None
    x = torch.zeros(1, 64, 64, 768, dtype=torch.bfloat16)
    assert 'head_dim' in swin_attn.refusal(x, 12, 14, None)


def _digest(sd):
    h = hashlib.sha256()
    for n, t in sd.items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_seeded_state_dict_draws_vit_tables_and_biases():
    """The ViT's linears and convs lecun-normal with their biases drawn
    alike (the transposed conv's fan-in its input channels), LayerNorms
    at (1, 0), ``pos_embed`` at 0.02 and the relative tables at 0.1; the
    head keeps the shared rule."""
    torch.set_num_threads(2)
    cfg = common.program_config(small_config())
    model = build_detector(cfg, dtype=torch.float32, device='cpu')
    sd = seeded_state_dict(model, 0)
    assert model.load_state_dict(sd).missing_keys == []
    kinds = {}
    for name, t in sd.items():
        if not name.startswith('backbone.'):
            continue
        module, _, leaf = name.rpartition('.')
        if leaf == 'pos_embed':
            assert float(t.std()) == pytest.approx(0.02, rel=0.1)
        elif leaf.startswith('rel_pos_'):
            assert float(t.std()) == pytest.approx(0.1, rel=0.4)
        elif module.endswith(('norm1', 'norm2')):
            assert bool((t == (1.0 if leaf == 'weight' else 0.0)).all())
        else:
            w = sd[f'{module}.weight']
            fan = w.shape[0] if 'simfp_' in module else w[0].numel()
            assert float(t.std()) == pytest.approx(fan ** -0.5, rel=0.35)
        kinds[leaf] = kinds.get(leaf, 0) + 1
    assert kinds == {'pos_embed': 1, 'rel_pos_h': 4, 'rel_pos_w': 4,
                     'weight': 26, 'bias': 26}
    assert not sd['neck.lateral_0.bias'].any()
    bare = vitdet.ViT(embed_dim=96, num_heads=3, depth=2, img_size=160)
    assert float(seeded_state_dict(bare, 0)['pos_embed'].std()) > 0.01


@pytest.mark.parametrize('cfg,want', [
    (R3DET_R50_V1,
     '3d2ff369af7ba4a66723fe60ffb5a7535b37622b7a7c2afb6c5852fcbdc5260f'),
    (DetectorConfig(backbone='swin'),
     'e7d5b74da250fa2b59c2178a3c6f7ffd236fd6241e84425816578325e2a22ee2'),
    (DetectorConfig(backbone='lsknet'),
     'e761c2a66137749dc3bf9cc58a86c9819805e857c9ae702b0cbd37d5651da2a6')],
    ids=['r50', 'swin_t', 'lsknet_s'])
def test_seeded_state_dict_keeps_the_other_backbones(cfg, want):
    """The sha256 of the names and bytes, as they were before the ViT
    rule."""
    torch.set_num_threads(2)
    model = build_detector(cfg, dtype=torch.float32, device='cpu')
    assert _digest(seeded_state_dict(model, 0)) == want


def _vit_model_dict(**backbone):
    from r3det_tpu_torch.dryrun import VITDET_B_RRETINANET
    d = json.loads(json.dumps(VITDET_B_RRETINANET))
    d['backbone'].update(dict(embed_dim=96, num_heads=3, depth=4,
                              window_block_indexes=[0, 2], window_size=4,
                              img_size=160), **backbone)
    d['neck']['in_channels'] = [48, 96, 96]
    d['bbox_head'].update(feat_channels=32, in_channels=32)
    return d


def test_builder_maps_the_vit_dict():
    model, cfg = build_from_config({'model': _vit_model_dict()},
                                   dtype=torch.float32, device='cpu')
    assert cfg.backbone == 'vitdet'
    assert (cfg.vit_img_size, cfg.vit_patch_size, cfg.vit_embed_dim,
            cfg.vit_depth, cfg.vit_num_heads, cfg.vit_mlp_ratio,
            cfg.vit_window_size, cfg.vit_global_blocks,
            cfg.vit_pretrain_grid) == (160, 16, 96, 4, 3, 4, 4, (1, 3), 14)
    hash(cfg)
    assert isinstance(model.backbone, vitdet.ViT)
    assert [b.window for b in model.backbone.blocks] == [4, 0, 4, 0]
    assert [getattr(model.neck, f'lateral_{i}').in_channels
            for i in range(3)] == [48, 96, 96]
    # ViT-B's own dict: the published sizes, the DetectorConfig defaults
    from r3det_tpu_torch.dryrun import VITDET_B_RRETINANET
    from r3det_tpu_torch.utils.builder import detector_config_from_dict
    full = detector_config_from_dict(VITDET_B_RRETINANET)
    assert full == DetectorConfig(**{
        k: getattr(full, k) for k in DetectorConfig._fields
        if not k.startswith('vit_')})
    # detectron2's all-global ViT (window_size 0), mmdet's LN2d norm and
    # the ignored arguments
    d = _vit_model_dict(window_size=0, norm_cfg=dict(type='LN2d'),
                        drop_path_rate=0.1, use_act_checkpoint=False,
                        init_cfg=None, pretrain_img_size=192)
    got = build_from_config({'model': d}, dtype=torch.float32,
                            device='cpu')[1]
    assert got.vit_global_blocks == (0, 1, 2, 3)
    assert got.vit_pretrain_grid == 12
    d['neck']['in_channels'] = [96, 96, 96]
    with pytest.raises(ValueError, match='in_channels'):
        build_from_config({'model': d}, dtype=torch.float32, device='cpu')
    for bad in (dict(use_rel_pos=False), dict(qkv_bias=False),
                dict(residual_block_indexes=[1]),
                dict(norm_cfg=dict(type='LN', eps=1e-5)),
                dict(act_cfg=dict(type='ReLU')), dict(in_chans=4)):
        with pytest.raises(NotImplementedError):
            build_from_config({'model': _vit_model_dict(**bad)},
                              dtype=torch.float32, device='cpu')


def test_print_config_shows_the_fields_the_backbone_reads():
    from r3det_tpu_torch.tools.print_config import derived_fields
    from r3det_tpu_torch.utils.builder import detector_config_from_dict
    got = derived_fields(detector_config_from_dict(_vit_model_dict()))
    assert got['backbone'] == 'vitdet'
    assert got['vit_global_blocks'] == (1, 3)
    assert not [k for k in got if k.startswith(('swin_', 'lsk_'))]
    assert 'backbone_depth' not in got and 'frozen_stages' not in got
    for cfg in (R3DET_R50_V1, DetectorConfig(backbone='swin'),
                DetectorConfig(backbone='lsknet')):
        assert not [k for k in derived_fields(cfg) if k.startswith('vit_')]


def test_dry_run_builds_the_vit_config(monkeypatch):
    """``entry(device, 'vitdet')`` through the builder, the dict cut to a
    small width so that a bf16 forward at 512^2 stays short on the CPU
    (the 32 x 32 grid resizes the global tables built for 10 x 10)."""
    from r3det_tpu_torch import dryrun
    torch.set_num_threads(2)
    monkeypatch.setitem(dryrun.MODEL_DICTS, 'vitdet', _vit_model_dict())
    fn, (x,) = dryrun.entry(device='cpu', backbone='vitdet')
    sums = fn(x)
    assert len(sums) == 10
    assert all(s.dim() == 0 and bool(torch.isfinite(s)) for s in sums)
