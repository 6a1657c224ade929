"""Detectors: RRetinaNet (single stage) and R3Det (cascaded refinement).

Port of ``r3det_tpu/models/detectors.py``: the config NamedTuples, the
``RRetinaNet`` / ``R3Det`` modules, ``build_detector``, ``level_anchors``,
``filter_bboxes``, ``refine_rois``, the training losses (``head_loss``,
``detector_loss``) and ``detector_predict``. ``filter_bboxes`` and
``refine_rois`` detach their rois, as the JAX package's ``stop_gradient``
does: the refine stages' rois and targets carry no gradient.

Layouts follow the JAX package: images NHWC (B, H, W, 3); head maps
(B, H, W, A*C) / (B, H, W, A*5) f32; rois per level (B, H*W, 5) f32;
predict returns (dets (B, max_per_img, 6), labels (B, max_per_img),
num (B,)).

``build_detector`` takes the JAX package's build options: the config's
``quantize`` (backbone, FPN and FRM branch convs) and ``quantize_head``
(head towers), each ``False | True | 'static'``, and ``hbb_anchors``
(horizontal xyxy base anchors, ``DeltaXYWHAHBBoxCoder``), and the keywords
``int8_act``, ``stem_fused_kernel`` (on by default in the port),
``stem_pool_kernel``, ``fused_blocks`` (see ``models/resnet.py``),
``frm_points``, ``frm_transpose_quirk``, ``frm_fuse_convs`` and
``frm_sample_kernel`` (see ``models/frm.py``).
The config's ``backbone`` names the trunk: ``'resnet'`` (the default,
``backbone_depth``), ``'swin'`` (``models/swin.py``, sized by the
``swin_*`` fields; Swin-T by default), ``'lsknet'``
(``models/lsknet.py``, sized by the ``lsk_*`` fields; LSKNet-S by
default) or ``'vitdet'`` (``models/vitdet.py``, sized by the ``vit_*``
fields; ViTDet's ViT-B by default). The ResNet-only options (``quantize``, ``quantize_head``,
``int8_act``, ``stem_fused_kernel``, ``stem_pool_kernel``,
``fused_blocks``) raise with another backbone unless they are at their
defaults.
``kernels`` (default on): the detector's forward runs under
``ops/route.py``'s ``kernels(self.kernels)``; off, the plain PyTorch
versions run everywhere.
"""
import functools
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core import coders
from ..core import rtransforms as rt
from ..core.anchors import RAnchorGenerator
from ..core.targets import TargetConfig, anchor_targets, num_total_samples
from ..ops import route
from ..ops.nms import multiclass_nms_rotated_batched
from ..parallel import dist
from ..utils.tracing import count_h2d, span
from .fpn import FPN
from .frm import FeatureRefineModule
from .lsknet import LSKNet
from .losses import (l1_loss, sigmoid_bce_loss, sigmoid_focal_loss,
                     smooth_l1_loss)
from .resnet import ResNet
from .retina_head import RRetinaHead
from .swin import SwinTransformer
from .vitdet import ViT


# ---------------------------------------------------------------------------
# Configs (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

class StageTrainCfg(NamedTuple):
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0
    assign_by_circumhbbox: Optional[str] = 'v1'
    sampler: Any = None


class TestCfg(NamedTuple):
    nms_pre: int = 2000
    score_thr: float = 0.05
    nms_iou_thr: float = 0.1
    max_per_img: int = 2000
    nms_version: str = 'v1'
    min_bbox_size: float = 0.0
    # TPU-only approximate top-k in the JAX package; the port selects
    # exactly and raises if asked for it
    approx_topk: bool = False
    # candidate budget across (position, class) pairs; None -> 2 * nms_pre
    nms_candidates: int = None


class DetectorConfig(NamedTuple):
    num_classes: int = 15
    angle_version: str = 'v1'
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (1.0, 0.5, 2.0)
    octave_base_scale: int = 4
    scales_per_octave: int = 3
    stacked_convs: int = 4
    refine_stacked_convs: int = None   # None -> same as stacked_convs
    feat_channels: int = 256
    num_refine_stages: int = 0                      # 0 => RRetinaNet
    stage_loss_weights: Tuple[float, ...] = ()
    s0_train: StageTrainCfg = StageTrainCfg()
    sr_train: Tuple[StageTrainCfg, ...] = ()
    test: TestCfg = TestCfg()
    target_means: Tuple[float, ...] = (0., 0., 0., 0., 0.)
    target_stds: Tuple[float, ...] = (1., 1., 1., 1., 1.)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    smooth_l1_beta: float = 0.11
    loss_bbox_type: str = 'smooth_l1'
    loss_cls_type: str = 'focal'
    frozen_stages: int = 1
    backbone_depth: int = 50
    hbb_anchors: bool = False
    quantize: Any = False
    quantize_head: Any = False
    # the trunk: 'resnet' (backbone_depth), 'swin' (the swin_* fields,
    # mmdet's SwinTransformer arguments; Swin-T's by default), 'lsknet'
    # (the lsk_* fields, mmrotate's LSKNet arguments; LSKNet-S's by default)
    # or 'vitdet' (the vit_* fields, detectron2's ViT arguments, the global
    # blocks those not in window_block_indexes, the pretrain grid
    # pretrain_img_size // patch_size; ViTDet's ViT-B by default)
    backbone: str = 'resnet'
    swin_embed_dims: int = 96
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    swin_window_size: int = 7
    swin_mlp_ratio: int = 4
    swin_patch_size: int = 4
    swin_out_indices: Tuple[int, ...] = (1, 2, 3)
    lsk_embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    lsk_depths: Tuple[int, ...] = (2, 2, 4, 2)
    lsk_mlp_ratios: Tuple[int, ...] = (8, 8, 4, 4)
    vit_img_size: int = 1024
    vit_patch_size: int = 16
    vit_embed_dim: int = 768
    vit_depth: int = 12
    vit_num_heads: int = 12
    vit_mlp_ratio: int = 4
    vit_window_size: int = 14
    vit_global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    vit_pretrain_grid: int = 14

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * self.scales_per_octave

    def coder(self):
        if self.hbb_anchors:
            return coders.DeltaXYWHAHBBoxCoder(
                self.target_means, self.target_stds, self.angle_version)
        return coders.DeltaXYWHAOBBoxCoder(
            self.target_means, self.target_stds, self.angle_version)

    def anchor_generator(self) -> RAnchorGenerator:
        return RAnchorGenerator(
            strides=self.strides, ratios=self.ratios,
            octave_base_scale=self.octave_base_scale,
            scales_per_octave=self.scales_per_octave)


R3DET_R50_V1 = DetectorConfig(
    num_refine_stages=1, stage_loss_weights=(1.0,),
    s0_train=StageTrainCfg(0.5, 0.4, 0.0, 'v1'),
    sr_train=(StageTrainCfg(0.6, 0.5, 0.0, None),))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _Base(nn.Module):
    """Backbone + FPN + the base rotated retina head."""

    def __init__(self, cfg, dtype, kernels, stem_fused_kernel,
                 stem_pool_kernel, fused_blocks, int8_act):
        super().__init__()
        self.cfg = cfg
        self.kernels = kernels
        if cfg.backbone != 'resnet':
            given = dict(quantize=cfg.quantize,
                         quantize_head=cfg.quantize_head,
                         int8_act=int8_act,
                         stem_fused_kernel=not stem_fused_kernel,
                         stem_pool_kernel=stem_pool_kernel,
                         fused_blocks=fused_blocks)
            bad = sorted(k for k, v in given.items() if v)
            if bad:
                raise ValueError(f'{bad}: ResNet-only options; a '
                                 f'{cfg.backbone!r} backbone takes them at '
                                 'their defaults')
        if cfg.backbone == 'swin':
            self.backbone = SwinTransformer(
                embed_dims=cfg.swin_embed_dims, depths=cfg.swin_depths,
                num_heads=cfg.swin_num_heads,
                window_size=cfg.swin_window_size,
                mlp_ratio=cfg.swin_mlp_ratio,
                patch_size=cfg.swin_patch_size,
                out_indices=cfg.swin_out_indices, dtype=dtype)
        elif cfg.backbone == 'lsknet':
            self.backbone = LSKNet(
                embed_dims=cfg.lsk_embed_dims, depths=cfg.lsk_depths,
                mlp_ratios=cfg.lsk_mlp_ratios, dtype=dtype)
        elif cfg.backbone == 'vitdet':
            self.backbone = ViT(
                img_size=cfg.vit_img_size, patch_size=cfg.vit_patch_size,
                embed_dim=cfg.vit_embed_dim, depth=cfg.vit_depth,
                num_heads=cfg.vit_num_heads, mlp_ratio=cfg.vit_mlp_ratio,
                window_size=cfg.vit_window_size,
                global_blocks=cfg.vit_global_blocks,
                pretrain_grid=cfg.vit_pretrain_grid, dtype=dtype)
        elif cfg.backbone == 'resnet':
            self.backbone = ResNet(
                depth=cfg.backbone_depth, dtype=dtype,
                frozen_stages=cfg.frozen_stages,
                stem_fused_kernel=stem_fused_kernel,
                stem_pool_kernel=stem_pool_kernel, quantize=cfg.quantize,
                fused_blocks=fused_blocks, int8_act=int8_act)
        else:
            raise ValueError(f'backbone {cfg.backbone!r}: not provided '
                             "('resnet', 'swin', 'lsknet' or 'vitdet')")
        self.neck = FPN(in_channels=self.backbone.out_channels,
                        out_channels=cfg.feat_channels,
                        quantize=cfg.quantize)
        self.bbox_head = RRetinaHead(
            num_classes=cfg.num_classes, in_channels=cfg.feat_channels,
            feat_channels=cfg.feat_channels, stacked_convs=cfg.stacked_convs,
            num_anchors=cfg.num_anchors, quantize=cfg.quantize_head)

    def forward(self, images):
        with route.kernels(self.kernels):
            return self.detect(images)


class RRetinaNet(_Base):
    """Backbone + FPN + rotated retina head. forward(images NHWC) ->
    {'s0': (cls_scores, bbox_preds)}. Spans (``utils/tracing.py``):
    ``backbone``, ``neck``, ``head.s0``."""

    def __init__(self, cfg: DetectorConfig, dtype=torch.bfloat16,
                 kernels=True, stem_fused_kernel=True, stem_pool_kernel=False,
                 fused_blocks=False, int8_act=False):
        super().__init__(cfg, dtype, kernels, stem_fused_kernel,
                         stem_pool_kernel, fused_blocks, int8_act)

    def detect(self, images):
        with span('backbone'):
            feats = self.backbone(images)
        with span('neck'):
            feats = self.neck(feats)
        with span('head.s0'):
            return {'s0': self.bbox_head(feats)}


class R3Det(_Base):
    """RRetinaNet base + N x (FRM + refine head).

    forward(images NHWC) -> {'s0': (cls, reg), 'sr': [(cls, reg), ...],
    'rois': [per-level (B, H*W, 5), ...]}. Spans (``utils/tracing.py``):
    ``backbone``, ``neck``, ``head.s0``, then each stage's ``frm.<i>`` and
    ``head.sr<i>``.
    """

    def __init__(self, cfg: DetectorConfig, dtype=torch.bfloat16,
                 frm_points=1, frm_transpose_quirk=True, frm_fuse_convs=False,
                 frm_sample_kernel=False, kernels=True,
                 stem_fused_kernel=True, stem_pool_kernel=False,
                 fused_blocks=False, int8_act=False):
        super().__init__(cfg, dtype, kernels, stem_fused_kernel,
                         stem_pool_kernel, fused_blocks, int8_act)
        for stage in range(cfg.num_refine_stages):
            self.add_module(f'frm_{stage}', FeatureRefineModule(
                in_channels=cfg.feat_channels, featmap_strides=cfg.strides,
                points=frm_points, transpose_quirk=frm_transpose_quirk,
                fuse_convs=frm_fuse_convs, sample_kernel=frm_sample_kernel,
                quantize=cfg.quantize))
            self.add_module(f'refine_head_{stage}', RRetinaHead(
                num_classes=cfg.num_classes, in_channels=cfg.feat_channels,
                feat_channels=cfg.feat_channels,
                stacked_convs=cfg.refine_stacked_convs or cfg.stacked_convs,
                num_anchors=1, quantize=cfg.quantize_head))

    def detect(self, images):
        cfg = self.cfg
        with span('backbone'):
            feats = self.backbone(images)
        with span('neck'):
            feats = self.neck(feats)
        with span('head.s0'):
            cls0, reg0 = self.bbox_head(feats)
        anchors = level_anchors(cfg, [tuple(f.shape[1:3]) for f in cls0],
                                images.device)
        coder = cfg.coder()
        # F9 (ROADMAP.md Queue 3): under hbb_anchors the JAX package hands
        # the HBB coder these (cx, cy, w, h, a) anchors unconverted, so it
        # reads them as xyxy; the port does the same
        rois = filter_bboxes(cls0, reg0, anchors, coder, cfg)
        out = {'s0': (cls0, reg0), 'sr': [], 'rois': []}
        for stage in range(cfg.num_refine_stages):
            with span(f'frm.{stage}'):
                feats = getattr(self, f'frm_{stage}')(feats, rois)
            with span(f'head.sr{stage}'):
                cls_i, reg_i = getattr(self, f'refine_head_{stage}')(feats)
            out['sr'].append((cls_i, reg_i))
            out['rois'].append(rois)
            if stage + 1 < cfg.num_refine_stages:
                rois = refine_rois(reg_i, rois, coder)
        return out


def build_detector(cfg: DetectorConfig, dtype=torch.bfloat16, device='cuda',
                   **kwargs):
    """The detector for ``cfg`` computing in ``dtype``, f32 parameters:
    moved to ``device``, the card by default, with channels_last weights.
    Without a card it raises; ``device='cpu'`` builds it on the CPU as it
    is constructed."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("build_detector: no CUDA card; pass "
                           "device='cpu' to build on the CPU")
    cls = R3Det if cfg.num_refine_stages > 0 else RRetinaNet
    model = cls(cfg, dtype=dtype, **kwargs).eval()
    if device.type == 'cpu':
        return model
    return model.to(device=device, memory_format=torch.channels_last)


def use_kernels(model: nn.Module, on: bool):
    """Set the detector's switch of the hand-written kernels."""
    model.kernels = bool(on)


# ---------------------------------------------------------------------------
# Helpers (anchors, cascade box plumbing)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _grid_anchors(cfg: DetectorConfig, featmap_sizes):
    return tuple(cfg.anchor_generator().grid_anchors(featmap_sizes))


def level_anchors(cfg: DetectorConfig, featmap_sizes, device=None):
    """Per-level (H*W*A, 5) f32 anchors on ``device``, copied in the span
    ``copy.anchors``, which counts their bytes."""
    sizes = tuple(tuple(int(v) for v in s) for s in featmap_sizes)
    with span('copy.anchors'):
        out = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
               for a in _grid_anchors(cfg, sizes)]
        count_h2d(*out)
    return out


def filter_bboxes(cls_scores, bbox_preds, anchors, coder, cfg):
    """Best-anchor decode per position (R3Det's pre-refine step): per
    level, keep the anchor with the highest class score at each position
    and decode it. Returns per-level (B, H*W, 5)."""
    a = cfg.num_anchors
    c = cfg.num_classes
    rois = []
    for cls, reg, anc in zip(cls_scores, bbox_preds, anchors):
        b, h, w, _ = cls.shape
        cls = cls.reshape(b, h * w, a, c)
        reg = reg.reshape(b, h * w, a, 5)
        anc = anc.reshape(1, h * w, a, 5).expand(b, -1, -1, -1)
        best = cls.amax(-1).argmax(-1)                        # (B, HW)
        idx = best[:, :, None, None].expand(-1, -1, 1, 5)
        best_reg = reg.gather(2, idx)[:, :, 0]
        best_anc = anc.gather(2, idx)[:, :, 0]
        rois.append(coder.decode(best_anc, best_reg).detach())
    return rois


def refine_rois(bbox_preds, rois, coder):
    """Decode refine-head deltas against the current rois (between
    refine stages)."""
    out = []
    for reg, roi in zip(bbox_preds, rois):
        b, h, w, _ = reg.shape
        out.append(coder.decode(roi, reg.reshape(b, h * w, 5)).detach())
    return out


def _flatten_levels(cls_scores, bbox_preds, num_classes):
    """Level lists of (B, H, W, A*C) / (B, H, W, A*5) -> (B, N, C) /
    (B, N, 5)."""
    b = cls_scores[0].shape[0]
    return (torch.cat([c.reshape(b, -1, num_classes) for c in cls_scores], 1),
            torch.cat([r.reshape(b, -1, 5) for r in bbox_preds], 1))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def head_loss(cls_scores, bbox_preds, anchors, gt_bboxes, gt_labels,
              gt_mask, cfg: DetectorConfig, stage: StageTrainCfg, coder,
              per_image_anchors=False, generator=None, process_group=None):
    """``(loss_cls, loss_bbox)`` of one head over all levels at once (one
    global avg_factor, so the reference's per-level sum is the same).

    With ``process_group`` the batch is this rank's part of the global
    batch: the avg_factor is summed over the group's ranks (each rank's
    losses are its own sums over the global avg_factor, so their sum is
    the global batch's loss) and a sampler keeps this rank's rows of the
    global draws."""
    cls_flat, reg_flat = _flatten_levels(cls_scores, bbox_preds,
                                         cfg.num_classes)
    tcfg = TargetConfig(
        pos_iou_thr=stage.pos_iou_thr, neg_iou_thr=stage.neg_iou_thr,
        min_pos_iou=stage.min_pos_iou,
        assign_by_circumhbbox=stage.assign_by_circumhbbox,
        angle_version=cfg.angle_version,
        hbb_anchors=cfg.hbb_anchors and not per_image_anchors,
        sampler=stage.sampler)
    shard = (0, 1) if process_group is None else (
        dist.rank(process_group), dist.world_size(process_group))
    tgts = anchor_targets(anchors, gt_bboxes, gt_labels, gt_mask,
                          coder.encode, cfg.num_classes, tcfg,
                          per_image_anchors=per_image_anchors,
                          generator=generator, shard=shard)
    # focal: num_total_pos; with a sampler pos + neg (each sum of max(n, 1))
    nts = num_total_samples(tgts.num_pos)
    if stage.sampler is not None:
        nts = nts + num_total_samples(tgts.num_neg)
    if process_group is not None:
        nts = dist.all_reduce_sum(nts, process_group)
    logits = cls_flat.reshape(-1, cfg.num_classes)
    labels = tgts.labels.reshape(-1)
    lw = tgts.label_weights.reshape(-1)
    if cfg.loss_cls_type == 'bce':
        loss_cls = sigmoid_bce_loss(logits, labels, lw, cfg.num_classes, nts)
    else:
        loss_cls = sigmoid_focal_loss(logits, labels, lw, cfg.num_classes,
                                      nts, gamma=cfg.focal_gamma,
                                      alpha=cfg.focal_alpha)
    args = (reg_flat.reshape(-1, 5), tgts.bbox_targets.reshape(-1, 5),
            tgts.bbox_weights.reshape(-1), nts)
    if cfg.loss_bbox_type == 'l1':
        loss_bbox = l1_loss(*args)
    else:
        loss_bbox = smooth_l1_loss(*args, beta=cfg.smooth_l1_beta)
    return loss_cls, loss_bbox


def detector_loss(outputs, cfg: DetectorConfig, featmap_sizes, gt_bboxes,
                  gt_labels, gt_mask, generator=None, kernels=True,
                  process_group=None):
    """The train loss: the base head ('s0') and each refine stage ('sr{i}',
    weighted by ``stage_loss_weights``), keys ``s0.loss_cls``,
    ``s0.loss_bbox``, ``sr0.loss_cls``, ... and their sum ``total``.

    ``generator`` feeds the RRandomSampler of stages that configure one
    (a generator seeded 0 when none is given); ``kernels`` off runs the
    targets under ``route.kernels(False)`` (the refine stages' rotated IoU
    takes its plain form on a card). With ``process_group`` the batch is
    this rank's part of the global batch (``head_loss``): the losses are
    this rank's share of the global batch's, and summed over the ranks
    they are the global losses."""
    coder = cfg.coder()
    dev = gt_bboxes.device
    anchors = torch.cat(level_anchors(cfg, featmap_sizes, dev), 0)
    if cfg.hbb_anchors:
        anchors = rt.obb2xyxy(anchors, cfg.angle_version)
    any_sampler = (cfg.s0_train.sampler is not None or
                   any(s.sampler is not None for s in cfg.sr_train))
    if any_sampler and generator is None:
        generator = torch.Generator(dev).manual_seed(0)

    losses = {}
    refine_coder = coders.DeltaXYWHAOBBoxCoder(
        cfg.target_means, cfg.target_stds, cfg.angle_version)
    with route.kernels(kernels):
        cls0, reg0 = outputs['s0']
        lc, lb = head_loss(cls0, reg0, anchors, gt_bboxes, gt_labels,
                           gt_mask, cfg, cfg.s0_train, coder,
                           generator=generator, process_group=process_group)
        losses['s0.loss_cls'] = lc
        losses['s0.loss_bbox'] = lb
        for i, (cls_i, reg_i) in enumerate(outputs.get('sr', [])):
            rois = torch.cat(outputs['rois'][i], 1)          # (B, N, 5)
            w = cfg.stage_loss_weights[i]
            lc, lb = head_loss(cls_i, reg_i, rois, gt_bboxes, gt_labels,
                               gt_mask, cfg, cfg.sr_train[i], refine_coder,
                               per_image_anchors=True, generator=generator,
                               process_group=process_group)
            losses[f'sr{i}.loss_cls'] = lc * w
            losses[f'sr{i}.loss_bbox'] = lb * w
    losses['total'] = sum(losses.values())
    return losses


def _top_positions(max_scores, k):
    """Indices of the k best positions, score-descending; ties in
    ascending index order (``lax.top_k``'s order)."""
    return torch.sort(max_scores, dim=1, descending=True,
                      stable=True).indices[:, :k]


def detector_predict(outputs, cfg: DetectorConfig, featmap_sizes,
                     img_shape=None, scale_factor=None, kernels=True):
    """Decode + NMS for a batch: (dets (B, max_per_img, 6), labels
    (B, max_per_img), num (B,)). ``kernels`` off runs it under
    ``route.kernels(False)`` (NMS's IoU takes its plain form on a card).
    Decode runs in the span ``decode``.

    Per level: top-``nms_pre`` positions by max class score, decode against
    the anchors (RRetinaNet) or the last stage's rois (R3Det), sigmoid
    scores + a background column, then version-matched multiclass NMS.
    """
    t = cfg.test
    if t.approx_topk:
        raise NotImplementedError('approx_topk is TPU-only; the port selects '
                                  'candidates exactly')
    with span('decode'):
        boxes, scores = _decode(outputs, cfg, featmap_sizes, img_shape,
                                scale_factor)
    with route.kernels(kernels):
        return multiclass_nms_rotated_batched(
            boxes, scores, score_thr=t.score_thr, iou_thr=t.nms_iou_thr,
            version=t.nms_version, max_num=t.max_per_img,
            pre_topk=min(t.nms_candidates or 2 * t.nms_pre,
                         boxes.shape[1] * cfg.num_classes),
            small_k=max(t.max_per_img, t.nms_pre))


def _decode(outputs, cfg, featmap_sizes, img_shape, scale_factor):
    """:func:`detector_predict`'s candidates: boxes (B, N, 5) and sigmoid
    scores with a background column (B, N, C + 1)."""
    t = cfg.test
    if outputs.get('sr'):
        cls_scores, bbox_preds = outputs['sr'][-1]
        rois = outputs['rois'][-1]
        anchors = None
        coder = coders.DeltaXYWHAOBBoxCoder(
            cfg.target_means, cfg.target_stds, cfg.angle_version)
    else:
        cls_scores, bbox_preds = outputs['s0']
        anchors = level_anchors(cfg, featmap_sizes, cls_scores[0].device)
        rois = None
        coder = cfg.coder()          # F9 under hbb_anchors, as in forward

    b = cls_scores[0].shape[0]
    mlvl_boxes, mlvl_scores = [], []
    for lvl, (cls, reg) in enumerate(zip(cls_scores, bbox_preds)):
        cls = cls.reshape(b, -1, cfg.num_classes)
        reg = reg.reshape(b, -1, 5)
        scores = torch.sigmoid(cls)
        if rois is not None:
            anc = rois[lvl]
        else:
            anc = anchors[lvl][None].expand(b, -1, -1)
        k = min(t.nms_pre, scores.shape[1])
        if k < scores.shape[1]:
            topk = _top_positions(scores.amax(-1), k)
            scores = scores.gather(
                1, topk[..., None].expand(-1, -1, scores.shape[-1]))
            reg = reg.gather(1, topk[..., None].expand(-1, -1, 5))
            anc = anc.gather(1, topk[..., None].expand(-1, -1, 5))
        mlvl_boxes.append(coder.decode(anc, reg, max_shape=img_shape))
        mlvl_scores.append(scores)

    boxes = torch.cat(mlvl_boxes, 1)                        # (B, N, 5)
    scores = torch.cat(mlvl_scores, 1)                      # (B, N, C)
    if t.min_bbox_size > 0:
        ok = (boxes[..., 2] >= t.min_bbox_size) & \
            (boxes[..., 3] >= t.min_bbox_size)
        scores = torch.where(ok[..., None], scores, torch.zeros_like(scores))
    if scale_factor is not None:
        sf = boxes.new_tensor(scale_factor)                 # (4,) wh wh
        boxes = torch.cat([boxes[..., :4] / sf, boxes[..., 4:]], -1)
    # background column (sigmoid heads)
    return boxes, torch.cat(
        [scores, scores.new_zeros(scores.shape[:-1] + (1,))], -1)
