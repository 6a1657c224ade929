"""Config dict -> the port's DetectorConfig and detector.

Port of ``r3det_tpu/utils/builder.py``: the mmdet dict schema of the
repository's ``configs/`` maps onto ``DetectorConfig``, ``TestCfg``,
``StageTrainCfg`` and ``SamplerCfg`` field for field, with the JAX
package's warnings for knobs it does not provide. ``build_from_config``
deep-merges the model's and the top-level train/test cfg the same way and
calls the port's ``build_detector``.

Every build option of the JAX package's builder reaches the port's
``build_detector``, ``frm_fuse_convs`` and ``frm_sample_kernel`` included.
``approx_topk`` in ``test_cfg`` (the TPU's ``lax.approx_max_k``) raises
``NotImplementedError`` when turned on, instead of being dropped: the port
selects candidates exactly.

The backbone dict's ``type`` picks the trunk: ``ResNet`` (``depth``,
``frozen_stages``), mmdet's ``SwinTransformer`` (``embed_dims``,
``depths``, ``num_heads``, ``window_size``, ``mlp_ratio``,
``patch_size``, ``out_indices`` onto the ``swin_*`` fields), mmrotate's
``LSKNet`` (``embed_dims``, ``depths``, ``mlp_ratios`` onto the ``lsk_*``
fields; the drop rates, ``norm_cfg``, ``img_size``, ``pretrained`` and
``init_cfg`` are accepted and ignored) or ViTDet's ``ViT`` (detectron2's
and mmdet's ``projects/ViTDet`` arguments: ``img_size``, ``patch_size``,
``embed_dim``, ``depth``, ``num_heads``, ``mlp_ratio``, ``window_size``
onto the ``vit_*`` fields, the blocks not in ``window_block_indexes`` onto
``vit_global_blocks``, ``pretrain_img_size // patch_size`` onto
``vit_pretrain_grid``; the drop-path rate, ``init_cfg`` and the
checkpointing flag are accepted and ignored; the port's three pyramid
levels stand in for the ``SimpleFeaturePyramid``). Such a backbone's neck
must lay its laterals on the backbone's last three outputs
(``in_channels[start_level:]``); the Swin variants the port does not
build (no qkv bias, a ``qk_scale``, no patch norm, an absolute position
embedding, other strides), an LSKNet of other input channels or another
stage count, and a ViT without qkv bias, the absolute or the relative
positions, the cls row, with residual conv blocks, another norm or
activation, or other input channels raise.
"""
import warnings

import torch

from ..core.samplers import SamplerCfg
from ..models.detectors import (DetectorConfig, StageTrainCfg, TestCfg,
                                build_detector)
from .config import Config

# cls losses that DISABLE train_cfg samplers in the reference
# (rotate_anchor_head.py:62-64: self.sampling = loss_cls['type'] not in
# this list; FocalLoss configs always get the PseudoSampler)
_NO_SAMPLING_LOSSES = ('FocalLoss', 'GHMC', 'QualityFocalLoss')


def _stage_sampler(train_cfg, sampling_active):
    """train_cfg['sampler'] dict -> SamplerCfg | None, reference-gated."""
    sampler = (train_cfg or {}).get('sampler')
    if not sampler or sampler.get('type') in (None, 'PseudoSampler'):
        return None
    stype = sampler.get('type')
    if stype != 'RRandomSampler':
        warnings.warn(f'train_cfg sampler {stype!r} is not provided; '
                      'using the PseudoSampler path')
        return None
    if not sampling_active:
        # reference semantics: with FocalLoss the sampler config is dead
        # (rotate_anchor_head.py:81-86 builds PseudoSampler regardless)
        warnings.warn('train_cfg sampler RRandomSampler is inactive under '
                      f'loss_cls in {_NO_SAMPLING_LOSSES} (reference '
                      'semantics: rotate_anchor_head.py:62-64,81-86)')
        return None
    return SamplerCfg(num=sampler.get('num', 256),
                      pos_fraction=sampler.get('pos_fraction', 0.5),
                      neg_pos_ub=float(sampler.get('neg_pos_ub', -1)))


def _stage_from_assigner(train_cfg, default_circum, sampling_active=False):
    a = train_cfg.get('assigner', {})
    return StageTrainCfg(
        pos_iou_thr=a.get('pos_iou_thr', 0.5),
        neg_iou_thr=a.get('neg_iou_thr', 0.4),
        min_pos_iou=a.get('min_pos_iou', 0.0),
        assign_by_circumhbbox=default_circum,
        sampler=_stage_sampler(train_cfg, sampling_active))


def detector_config_from_dict(model: dict, train_cfg: dict = None,
                              test_cfg: dict = None) -> DetectorConfig:
    """Map an mmdet-style model dict (+train/test cfg) to DetectorConfig."""
    model = dict(model)
    train_cfg = dict(train_cfg or model.get('train_cfg') or {})
    test_cfg = dict(test_cfg or model.get('test_cfg') or {})
    head = dict(model.get('bbox_head', {}))
    ag = dict(head.get('anchor_generator', {}))
    coder = dict(head.get('bbox_coder', {}))
    loss_bbox = dict(head.get('loss_bbox', {}))
    loss_cls = dict(head.get('loss_cls', {}))
    angle_version = coder.get('angle_range', 'v1')

    is_r3det = model.get('type') == 'R3Det'
    num_refine = model.get('num_refine_stages', 0) if is_r3det else 0

    # assign_by_circumhbbox: RAnchorHead defaults to 'v1' when unset
    circum = head.get('assign_by_circumhbbox', 'v1')

    lc_type = loss_cls.get('type', 'FocalLoss')
    sampling = lc_type not in _NO_SAMPLING_LOSSES

    if is_r3det:
        s0 = _stage_from_assigner(train_cfg.get('s0', {}), circum, sampling)
        sr = []
        for i, sr_cfg in enumerate(train_cfg.get('sr', [])):
            rh = (model.get('refine_heads') or [{}] * (i + 1))[i]
            sr.append(_stage_from_assigner(
                sr_cfg, rh.get('assign_by_circumhbbox', None), sampling))
        stage_w = tuple(train_cfg.get('stage_loss_weights',
                                      [1.0] * num_refine))
        sr = tuple(sr) if sr else tuple(
            StageTrainCfg(0.6, 0.5, 0.0, None) for _ in range(num_refine))
        # a TOP-LEVEL sampler key in an R3Det train_cfg is dead config (the
        # reference's heads read train_cfg.s0 / train_cfg.sr[i] only), but
        # silence would hide a user mistake
        if (train_cfg.get('sampler') or {}).get('type') not in (
                None, 'PseudoSampler'):
            warnings.warn('R3Det train_cfg.sampler at the TOP level is '
                          'ignored (reference reads s0/sr stage dicts); '
                          'put it under train_cfg.s0 / train_cfg.sr[i]')
    else:
        s0 = _stage_from_assigner(train_cfg, circum, sampling)
        sr, stage_w = (), ()

    nms = dict(test_cfg.get('nms', {}))
    nms_version = nms.get('type', angle_version)
    if nms_version not in ('v1', 'v2', 'v3', 'mmcv'):
        warnings.warn(f'unknown nms type {nms_version!r}; '
                      f'falling back to angle version {angle_version}')
        nms_version = angle_version

    lb_type = loss_bbox.get('type', 'SmoothL1Loss')
    if lc_type == 'CrossEntropyLoss' and loss_cls.get('use_sigmoid', False):
        loss_cls_type = 'bce'
    elif lc_type == 'FocalLoss':
        loss_cls_type = 'focal'
    else:
        warnings.warn(f'loss_cls {lc_type!r} is not provided; '
                      'falling back to FocalLoss')
        loss_cls_type = 'focal'
    return DetectorConfig(
        num_classes=head.get('num_classes', 15),
        angle_version=angle_version,
        strides=tuple(ag.get('strides', (8, 16, 32, 64, 128))),
        ratios=tuple(ag.get('ratios', (1.0, 0.5, 2.0))),
        octave_base_scale=ag.get('octave_base_scale', 4),
        scales_per_octave=ag.get('scales_per_octave', 3),
        stacked_convs=head.get('stacked_convs', 4),
        refine_stacked_convs=(model.get('refine_heads') or
                              [{}])[0].get('stacked_convs'),
        feat_channels=head.get('feat_channels', 256),
        num_refine_stages=num_refine,
        stage_loss_weights=stage_w,
        s0_train=s0, sr_train=sr,
        test=TestCfg(
            nms_pre=test_cfg.get('nms_pre', 2000),
            score_thr=test_cfg.get('score_thr', 0.05),
            nms_iou_thr=nms.get('iou_thr', 0.1),
            max_per_img=test_cfg.get('max_per_img', 2000),
            nms_version=nms_version,
            min_bbox_size=test_cfg.get('min_bbox_size', 0.0),
            # framework extensions (absent from reference configs): the
            # static NMS candidate budget and the TPU's approx top-k
            nms_candidates=test_cfg.get('nms_candidates'),
            approx_topk=test_cfg.get('approx_topk', False)),
        target_means=tuple(coder.get('target_means', (0.,) * 5)),
        target_stds=tuple(coder.get('target_stds', (1.,) * 5)),
        focal_gamma=loss_cls.get('gamma', 2.0),
        focal_alpha=loss_cls.get('alpha', 0.25),
        smooth_l1_beta=loss_bbox.get('beta', 0.11),
        loss_bbox_type='l1' if lb_type == 'L1Loss' else 'smooth_l1',
        loss_cls_type=loss_cls_type,
        frozen_stages=model.get('backbone', {}).get('frozen_stages', 1),
        backbone_depth=model.get('backbone', {}).get('depth', 50),
        **_swin_fields(model),
        **_lsk_fields(model),
        **_vit_fields(model),
        # framework extension: int8 PTQ serving (models/quant.py)
        quantize=_quant_flag(model, test_cfg, 'quantize_int8'),
        quantize_head=_quant_flag(model, test_cfg, 'quantize_head_int8'),
    )


_SWIN_KEYS = ('embed_dims', 'depths', 'num_heads', 'window_size',
              'mlp_ratio', 'patch_size', 'out_indices')
# mmdet SwinTransformer arguments the port builds only at these values
_SWIN_FIXED = dict(qkv_bias=True, qk_scale=None, patch_norm=True,
                   use_abs_pos_embed=False)


def _swin_fields(model):
    """The ``backbone`` and ``swin_*`` fields of an mmdet model dict ({}
    for a ResNet)."""
    bb = dict(model.get('backbone', {}))
    if bb.get('type') != 'SwinTransformer':
        return {}
    for key, want in _SWIN_FIXED.items():
        if bb.get(key, want) != want:
            raise NotImplementedError(
                f'SwinTransformer {key}={bb[key]!r}: the port builds '
                f'{key}={want!r} only')
    fields = {f'swin_{k}': tuple(bb[k]) if isinstance(bb[k], (list, tuple))
              else bb[k] for k in _SWIN_KEYS if k in bb}
    d = DetectorConfig(**fields)
    patch = d.swin_patch_size
    if tuple(bb.get('strides', (patch, 2, 2, 2))) != (patch, 2, 2, 2):
        raise NotImplementedError(f"SwinTransformer strides "
                                  f"{bb['strides']!r}: the port builds "
                                  f"({patch}, 2, 2, 2) only")
    widths = [d.swin_embed_dims * 2 ** i for i in d.swin_out_indices]
    _check_neck(model, widths, 'Swin')
    return dict(fields, backbone='swin')


def _check_neck(model, widths, kind):
    """Raise unless the neck's laterals lie on the last three of the
    backbone's output ``widths``."""
    neck = dict(model.get('neck', {}))
    used = list(neck.get('in_channels', widths))[neck.get('start_level', 0):]
    if used != list(widths[-3:]):
        raise ValueError(f'neck in_channels[start_level:] {used} do not '
                         f'fit the {kind} outputs {list(widths)}: the FPN '
                         'lays its laterals on the last three')


_LSK_KEYS = ('embed_dims', 'depths', 'mlp_ratios')


def _lsk_fields(model):
    """The ``backbone`` and ``lsk_*`` fields of an mmrotate model dict ({}
    for another backbone)."""
    bb = dict(model.get('backbone', {}))
    if bb.get('type') != 'LSKNet':
        return {}
    d = DetectorConfig(**{f'lsk_{k}': tuple(bb[k]) for k in _LSK_KEYS
                          if k in bb})
    if bb.get('in_chans', 3) != 3:
        raise NotImplementedError(f"LSKNet in_chans={bb['in_chans']!r}: "
                                  'the port takes RGB images only')
    stages = bb.get('num_stages', len(d.lsk_depths))
    if not stages == len(d.lsk_depths) == len(d.lsk_embed_dims) \
            == len(d.lsk_mlp_ratios):
        raise ValueError(f'LSKNet num_stages={stages}, embed_dims '
                         f'{d.lsk_embed_dims}, depths {d.lsk_depths}, '
                         f'mlp_ratios {d.lsk_mlp_ratios}: one a stage')
    _check_neck(model, d.lsk_embed_dims, 'LSKNet')
    return dict(lsk_embed_dims=d.lsk_embed_dims, lsk_depths=d.lsk_depths,
                lsk_mlp_ratios=d.lsk_mlp_ratios, backbone='lsknet')


_VIT_KEYS = ('img_size', 'patch_size', 'embed_dim', 'depth', 'num_heads',
             'mlp_ratio', 'window_size')
# ViT arguments (detectron2's and mmdet's names) the port builds only at
# these values; an empty residual_block_indexes in either form
_VIT_FIXED = dict(in_chans=3, qkv_bias=True, use_abs_pos=True,
                  use_rel_pos=True, pretrain_use_cls_token=True,
                  residual_block_indexes=())


def _vit_fields(model):
    """The ``backbone`` and ``vit_*`` fields of a ViTDet model dict ({} for
    another backbone)."""
    bb = dict(model.get('backbone', {}))
    if bb.get('type') != 'ViT':
        return {}
    for key, want in _VIT_FIXED.items():
        got = bb.get(key, want)
        if (tuple(got) if key == 'residual_block_indexes' else got) != want:
            raise NotImplementedError(f'ViT {key}={got!r}: the port builds '
                                      f'{key}={want!r} only')
    norm, act = bb.get('norm_cfg', {}), bb.get('act_cfg', {})
    if norm.get('type', 'LN') not in ('LN', 'LN2d') \
            or norm.get('eps', 1e-6) != 1e-6 or act.get('type', 'GELU') \
            != 'GELU':
        raise NotImplementedError(f'ViT norm_cfg={norm!r}, act_cfg={act!r}: '
                                  'the port builds LayerNorm (eps 1e-6) and '
                                  'exact GELU only')
    d = DetectorConfig(**{f'vit_{k}': bb[k] for k in _VIT_KEYS if k in bb})
    windowed = set(bb.get('window_block_indexes', ())) \
        if d.vit_window_size else set()
    fields = dict(
        {f'vit_{k}': getattr(d, f'vit_{k}') for k in _VIT_KEYS},
        vit_global_blocks=tuple(i for i in range(d.vit_depth)
                                if i not in windowed),
        vit_pretrain_grid=bb.get('pretrain_img_size', 224)
        // d.vit_patch_size)
    c = d.vit_embed_dim
    _check_neck(model, (c // 2, c, c), 'ViT')
    return dict(fields, backbone='vitdet')


def _quant_flag(model, test_cfg, key):
    """int8 PTQ flags: False | True | 'static' (models/quant.py)."""
    v = model.get(key, test_cfg.get(key, False))
    return v if v == 'static' else bool(v)


# serving-kernel module flags reachable from configs (framework
# extension, like quantize_int8): accepted in the model dict or
# test_cfg. The FRM keys exist only on R3Det and are dropped for
# RRetinaNet models.
_KERNEL_FLAG_KEYS = ('stem_fused_kernel', 'fused_blocks',
                     'stem_pool_kernel', 'frm_sample_kernel',
                     'frm_fuse_convs', 'int8_act')
_R3DET_ONLY_KWARGS = ('frm_sample_kernel', 'frm_fuse_convs', 'frm_points',
                      'frm_transpose_quirk')


def build_from_config(cfg, dtype=torch.bfloat16, device='cuda',
                      **model_kwargs):
    """Config (``Config`` or dict) -> (detector, DetectorConfig).

    ``model_kwargs`` forward to ``build_detector`` (e.g. ``kernels``,
    ``stem_fused_kernel``, ``fused_blocks``); the kernel flags are also
    accepted as config keys in the model dict or test_cfg, with explicit
    kwargs winning. The detector is built on ``device``, the card unless
    the caller asks for the CPU."""
    cfg_dict = cfg.to_dict() if hasattr(cfg, 'to_dict') else dict(cfg)
    model_d = cfg_dict['model']
    # mmdet accepts train/test cfg both inside `model` and at top level;
    # deep-merge with top level winning so `--cfg-options test_cfg.x=y`
    # and child-config overrides take effect over the model-embedded base
    # without wiping sibling keys of nested dicts
    train_cfg = Config._merge(dict(model_d.get('train_cfg') or {}),
                              dict(cfg_dict.get('train_cfg') or {}))
    test_cfg = Config._merge(dict(model_d.get('test_cfg') or {}),
                             dict(cfg_dict.get('test_cfg') or {}))
    det_cfg = detector_config_from_dict(model_d, train_cfg, test_cfg)
    kwargs = {}
    for key in _KERNEL_FLAG_KEYS:
        v = model_d.get(key, test_cfg.get(key))
        if v is not None:
            kwargs[key] = v if isinstance(v, str) else bool(v)
    kwargs.update(model_kwargs)
    if det_cfg.num_refine_stages == 0:     # RRetinaNet: no FRM module
        for key in _R3DET_ONLY_KWARGS:
            kwargs.pop(key, None)
    if det_cfg.test.approx_topk:
        raise NotImplementedError(
            "test_cfg 'approx_topk' is the TPU's lax.approx_max_k, which the "
            'port does not provide (ROADMAP.md, Not to port): it selects '
            'candidates exactly')
    model = build_detector(det_cfg, dtype=dtype, device=device, **kwargs)
    return model, det_cfg
