#!/usr/bin/env python3
"""Smoke run of the r3det_tpu_torch serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is 1):

1. device: the card's name and count, and nvidia-smi's name and power limit;
2. build: compiles the CUDA kernels (``r3det_tpu_torch/csrc``) with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it (max |diff| within the stated
   tolerance, 0 for K1, which also prints the pairs its far-pair cull
   leaves to integrate, ``near_pairs``, and for K2, one launch for the five
   levels with points 1 and 5; both times from CUDA events after
   warm-up; the stem kernel on weights packed once and K2 on arguments
   built once, each beside ``wrapper_ms``, the whole call), beside its bound
   (``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and
   its operations over the card's peak for their type) and, where one
   PyTorch call computes the same function, that call's time
   (``library_ms``). K5 and K5 int8 run at R50's identity blocks (C2, C3,
   C4) on weights packed once (``pack_ms`` apart), int8 bit-equal, each
   beside the block it replaces unfused (``unfused_ms``: bf16
   ``Bottleneck.forward``, int8 ``Bottleneck.q8_fused_forward``). QConv's
   int8 conv runs at eight main-path shapes, with
   the fused epilogue each takes there, beside a bf16 cuDNN conv of the
   same shape (``cudnn_bf16_ms``, a yardstick the port never calls).
   K2's backward runs at the training shapes (the five levels of a 1024^2
   image, batch 2, points 1, and points 5 once), within a bf16 ulp of the
   plain backward computed in f32 (``frm_bwd_check``), beside the plain
   bf16 backward's time and its gap. The conv epilogue
   (``csrc/conv_epilogue.cu``) runs at each distinct shape of the 48 a
   ResNet-50 predict step makes (batch 8 of 1024^2), bit-equal to its
   plain form, beside the unfused PyTorch passes it replaces
   (``unfused_ms``) and its bytes bound; ``[kernel_sum]`` weighs them by
   their launches a step. Swin's attention kernels (``csrc/swin_attn.cu``)
   run at Swin-T's four stage shapes of batch 8 of 1024^2, the window
   attention unshifted and shifted, each within the card tests' tolerance
   of its plain form, beside its plain time and bytes bound, summed by
   ``[kernel_sum]`` over the 12 launches of a forward. LSKNet's attention
   kernels (``csrc/lsk_attn.cu``: the taps, the selection, the three
   epilogues) run at LSKNet-S's four stage shapes of batch 8 of 1024^2 on
   the route's own products, each within the card tests' tolerance of its
   plain form, beside its plain time and its bound (``lsk_attn_work``),
   with the whole sub-block on the route against the eager one
   (``name=lsk_attention``), summed by ``[kernel_sum]`` over the 10
   launches of a forward; its MLP kernels (the same file: ``lsk_dw_gelu``,
   ``lsk_bias_scale``) the same way beside ``lsk_mlp_work``, the whole
   sub-block as ``name=lsk_mlp``. The NMS sweep
   (``csrc/nms_sweep.cu``) runs on K1's IoU of SWEEP_SCENES' candidates
   (8 x 4000 with ~3000 live, 8 x 2000 with ~300; 15 labels), keeping its
   plain route's set, beside that route's time (its fixpoint's host syncs
   included) and the bound of the same-label pairs' IoU read once;
4. end to end: R3Det* tiny (stacked_convs=2, angle v1), ResNet-50, full
   width, bf16, batch 8 of 1024^2 patches, weights from a numpy seed,
   through ``build_detector`` and the port's predict step. The refine
   head's final cls layer is set from the seed so that one batch sends more
   than 2000 live candidates per image to NMS (the full sweep) and the
   other fewer (the small sweep); every kernel of the path must launch in
   that run. The same batches then go through the plain versions on the
   card, and K1 alone runs on the big batch's own NMS candidates
   (``shape=main_path``: bit-equal, timed, with their near-pair share);
   no Swin kernel runs there. ``[swin]``: a bf16 Swin-T backbone (seeded,
   batch 8 of 1024^2) with its counts reset launches each attention
   kernel 12 times and no other kernel, and its outputs err no more
   against its float32 run than the eager bf16 route's. ``[lsk]``: a bf16
   LSKNet-S backbone (seeded, batch 8 of 1024^2) launches each attention
   and MLP kernel 10 times and no other kernel, its outputs err within 1.25
   times
   the eager bf16 route's against its float32 run, and its ms a forward
   beside the eager route's.
   Then ``[nms_stream]``: the same model and batch with
   ``nms_candidates=STREAM_CANDIDATES`` (8000) and the refine cls bias set
   for about STREAM_LIVE (6000) live candidates an image: the big
   branch streams (K, 512) IoU slabs, K1 once a block (16 times a predict
   step); NMS with K1 keeps what the plain IoU keeps; the streamed sweep
   alone on the first STREAM_CUT sorted candidates keeps what the dense
   sweep keeps; ms a step, patches/s and peak memory beside the dense
   (8, 8000, 8000) f32 matrix it replaces (computed); K1 alone on the
   costliest slab (bit-equal, timed, its bound and near pairs). Then
   ``[nms_family]``: on seeded scenes of NMS_FAMILY_K boxes, ``rnms``,
   ``batched_rnms``, ``ml_nms_rotated``, ``obb_batched_nms`` and
   ``multiclass_nms_rotated`` (v1/v2/v3/mmcv) keep the same boxes with K1
   as with the plain IoU, ``rbbox_overlaps_v1/v2/v3`` equal their plain
   forms, ``poly_nms`` reports its count.
   Then the int8 serving path (``quantize='static'``,
   ``quantize_head='static'``, ``int8_act``, fused stem) on the same
   weights, calibrated with ``calibrate`` on the seeded batch: its kernels
   must launch (the int8 conv once per QConv, 115 times), its refine
   logits must equal its plain route's exactly and be near the bf16
   path's, every detection must be found both ways, and its patches/s is
   measured beside the bf16 path's. One ``[profile]`` line per path:
   ``torch.profiler`` over one step of the big batch, the top device
   kernels and the device's busy share. The stem kernel and K2 must run
   once a predict step in both. Then the DOTA evaluation path
   (``[eval]``): the port's fake-DOTA maker writes EVAL_IMAGES scenes split
   into 512^2 patches (gap 128), ``configs/debug/r3det_tiny_fake_dota.py``
   through the port's builder gives R3Det* tiny R50 (3 classes, full
   width, bf16, seeded weights, the refine cls layer set as above) and
   ``evaluate_dataset`` reads, decodes and resizes each patch to 1024^2 on
   the card, predicts and undoes the scale. Checks: ground truth fed as
   detections through ``merge_det`` and ``evaluate`` against the scenes'
   own labels scores mAP 1.0, shifted by EVAL_SHIFT px under 0.1; the
   transforms on the card equal the CPU's bit for bit; K1, K2 and K3 once
   a predict step; kernel route against plain route (``_agreement`` >=
   0.75 both ways, each class's AP both ways); the int8 serving
   configuration calibrated on EVAL_CALIBRATE batches equal to its plain
   route exactly (115 int8 conv launches a step); ``format_results``
   writes the Task1 files and the zip. It prints images/s end to end and
   the seconds in decoding, transforms, predict steps (median and range
   over EVAL_REPEATS runs), ``merge_det`` and ``evaluate``, and the
   decode's own split (``[eval_decode]``: file read, inflate, unfilter,
   the rest). Then the same weights in an f32 model at
   batch 1: only NMS's IoU kernel may launch, and its outputs must equal
   its plain route's; and in bf16 with ``frm_points=5`` at batch 2 (the
   ``[frm5]`` line): K2 once a forward, outputs equal to the FRM's plain
   route; and the FRM build options at batch 2 (``[frm_options]``):
   ``frm_fuse_convs`` runs K2 once a forward and equals its FRM's plain
   route (its relative distance from the unfused model printed), and
   ``frm_sample_kernel='band'`` equals the default model bit for bit;
5. opt-in routes, batch 2: bf16 with ``fused_blocks`` and the unfused stem
   with ``stem_pool_kernel`` (launches K5 and K4), and int8 with
   ``fused_blocks`` (launches K5 int8), each held to the unfused model;
6. training (``[train]``): R3Det R50 as shipped (``R3DET_R50_V1``,
   ``stacked_convs=4``), bf16 compute on f32 parameters, seeded weights,
   ``SyntheticDetData`` batch 2 of 1024^2 with ``max_gt=64``, through
   ``make_train_step`` (the shipped SGD and schedule). One step's losses
   and gradients on the kernel route are held to the plain route's
   (``use_kernels(model, False)``) on the same weights and batch; then
   TRAIN_WARMUP steps and TRAIN_STEPS timed steps (CUDA events) on the same
   batch: every loss finite, the last total below the first, K1, K2, K2's
   backward and K3 once a step, ms a step, images/s and peak memory. The
   ``[train_f32]`` line holds each bf16 route's gradients against one f32
   step of the same weights and batch (relative L2, overall and the worst
   five parameters; which route lies nearer). ``[hbb_train]``: one train
   step of rotated RetinaNet v1 with ``hbb_anchors`` (R50, batch 2 of
   1024^2, seeded): finite losses, K1 once in the rotated assignment, K3
   once, ms a step;
7. the train CLI from DOTA files (``[train_cli]``), in a temporary
   directory: the port's fake-DOTA maker writes EVAL_IMAGES scenes split
   into 512^2 patches; ``tools/train.py``'s ``main`` trains R3Det R50 as
   shipped (``configs/r3det/r3det_r50_fpn_1x_dota_v1.py``, batch 2 of
   1024^2, seeded weights) for TRAIN_CLI_STEPS[0] steps, saves a
   checkpoint and runs the eval hook (its mAP printed); the checkpoint
   restored into a new model and optimizer equals the saved state bit for
   bit; the CLI resumed from it to TRAIN_CLI_STEPS[1] continues the step,
   the update count and the LR, its losses finite, K1, K2, K2's backward
   and K3 once a step; ms a step, images/s and the share of the loop's
   time spent waiting in ``next(loader)`` over the resumed run's steps
   after TRAIN_CLI_WARMUP, its peak memory, and a ``[profile]`` line of
   one iteration (the loader's next batch and a step). Then rotated
   RetinaNet with PolyRandomRotate (``rretinanet_obb_r50_fpn_1x_dota_
   ms_rr_v3.py``) trains 4 steps, and its first batch from the card's
   pipeline equals the CPU pipeline's (images bit for bit, boxes exactly);
8. data parallelism, each rank a process (``chip_smoke.py --ddp-worker``,
   or torchrun), with a timeout and a process-group timeout.
   ``[ddp_step]``: R3Det R50 as shipped, bf16 on f32 parameters, seeded
   weights (rank 1 starts from others: the broadcast gives it rank 0's),
   DDP_RANKS ranks on card 0 over gloo, each its rows of one
   ``SyntheticDetData`` batch of DDP_BATCH 1024^2 images (``max_gt=64``),
   DDP_STEPS steps of the data-parallel ``make_train_step`` against one
   process stepping the whole batch on the card: losses within
   TRAIN_LOSS_RTOL, parameters within TRAIN_GRAD_RTOL of the update
   (relative L2), the ranks bit-identical after every step (a checksum
   all-gather), K1, K2, K2's backward and K3 once a step on every rank;
   ms a step and the gradient all-reduce's ms (rank 0), peak memory per
   rank (ranks sharing a card check the function, not the speed).
   ``[ddp_nccl]``: the same over NCCL, one rank a card, as many ranks as
   cards up to 4 (one on a one-card machine, which still runs NCCL's init
   and all-reduce). ``[ddp_cli]``: ``torchrun --standalone
   --nproc_per_node 2 -m r3det_tpu_torch.tools.train`` on the shipped R50
   config over gloo on cuda:0 from a fake-DOTA split, DDP_CLI_STEPS[0]
   steps with the eval hook, then resumed to DDP_CLI_STEPS[1]: rank 0's
   log and checkpoint alone, the step, count and LR continued.
   ``[ddp_eval]``: the test CLI on the last checkpoint with ``--eval mAP``
   on 2 ranks and on 1: every image once, the detections' agreement
   (``_agreement``, >= 0.75) and both mAPs;
9. the last tools. ``[kernel_bench]``: ``tools/kernel_bench.py all`` (the
   stem, the C2 and C3 identity blocks and the FRM sample at batch 32,
   Swin's attention kernels at batch 8, each kernel beside its plain
   form): every int8 parity and K2's and K4's exact, K3 bf16 within one
   bf16 ulp, K5 bf16 within 0.03125, Swin's within 2^-5, each variant's
   ms. ``[vis]``: the ``[eval]`` phase's results pickle through
   ``tools/analyze_results.py --topk 2`` (``bad/`` and ``good/`` PNGs
   named ``{mAP:.3f}_{id}.png`` that decode), and
   ``tools/browse_dataset.py --limit 4`` on the card equal to its run
   with ``--device cpu``, PNG for PNG. ``[dryrun]``: ``dryrun.entry()``
   (R3Det R50, bf16, a 512^2 zero image) on the card, K3 and K2 launched,
   every output sum finite; then ``dryrun_multichip(2)`` on the CPU.

Prints the kernels' JSON record on the line before the last, and as the
last line ``{"ok": true, "device": {...}}``. Needs one card; exits non-zero
without one, and without the rest of the repository.
"""
import json
import math
import os
import pickle
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from r3det_tpu_torch.utils.kernel_timing import (  # noqa: E402
    add_bound, add_bound_ms, cuda_ms, epilogue_bytes, frm_work, graph_ms,
    iou_work, lsk_attn_work, lsk_mlp_work, nms_sweep_work, r50_epilogues,
    swin_attn_work)

SEED = 0
BATCH = 8
SIZE = 1024
# main-path shapes of each kernel
IOU_BUDGETS = (4000, 2000)        # NMS candidate budgets: full and small
# the sweep kernel's scenes: (candidates, live an image), dense and sparse
SWEEP_SCENES = ((4000, (2900, 3100)), (2000, (250, 350)))
SWEEP_LABELS = 15
FRM_SIZES = (128, 64, 32, 16, 8)  # P3..P7 at 1024^2
FRM_CHANNELS = 256
LIVE_TARGETS = {'big': 3000, 'small': 1000}   # live candidates per image
STREAM_CANDIDATES = 8000          # nms_candidates of the streamed-sweep run
STREAM_LIVE = 6000                # its live candidates per image (about)
STREAM_CUT = 4000                 # candidates of the streamed-vs-dense check
NMS_FAMILY_K = 2000               # boxes of each [nms_family] scene
# R50 identity bottlenecks at 1024^2: (name, (B, H, W, 4F), F)
BOTTLENECKS = (('C2', (BATCH, 256, 256, 256), 64),
               ('C3', (BATCH, 128, 128, 512), 128),
               ('C4', (BATCH, 64, 64, 1024), 256))
# Swin-T's stages at 1024^2: (map side, C, heads, blocks); window 7, and
# every second block of a stage shifted by 3
SWIN_STAGES = ((256, 96, 3, 2), (128, 192, 6, 2), (64, 384, 12, 6),
               (32, 768, 24, 2))
SWIN_WINDOW = 7
SWIN_BLOCKS = 12                  # attention sub-blocks of a Swin-T forward
# LSKNet-S's stages at 1024^2: (map side, C, blocks)
LSK_STAGES = ((256, 64, 2), (128, 128, 2), (64, 320, 4), (32, 512, 2))
LSK_RATIOS = (8, 8, 4, 4)         # its MLP ratios
LSK_BLOCKS = 10                   # blocks (each sub-block) of a forward
LSK_ATTN_KERNELS = ('lsk_taps', 'lsk_select', 'lsk_bias_gelu',
                    'lsk_bias_gate', 'lsk_bias_residual')
LSK_MLP_KERNELS = ('lsk_dw_gelu', 'lsk_bias_scale')
ROUTE_BATCH = 2                   # batch of the opt-in routes
EVAL_CONFIG = 'configs/debug/r3det_tiny_fake_dota.py'
EVAL_IMAGES = 8                   # fake-DOTA scenes (700^2): 4 patches each
EVAL_BATCH = 8
EVAL_CALIBRATE = 2                # --calibrate-int8 batches
EVAL_SHIFT = 99                   # px: ground truth moved off itself
EVAL_REPEATS = 5                  # timed runs of the eval loop
VIS_TOPK = 2                      # [vis]: analyze_results --topk
VIS_LIMIT = 4                     # [vis]: browse_dataset --limit
TRAIN_BATCH = 2                   # samples_per_gpu of the shipped config
TRAIN_MAX_GT = 64
TRAIN_WARMUP = 2                  # train steps before the timed ones
TRAIN_STEPS = 8                   # timed train steps
TRAIN_CLI_CONFIG = 'configs/r3det/r3det_r50_fpn_1x_dota_v1.py'
TRAIN_CLI_ROTATE = ('configs/rretinanet/'
                    'rretinanet_obb_r50_fpn_1x_dota_ms_rr_v3.py')
TRAIN_CLI_STEPS = (4, 8)          # run 1's steps, then resumed to
TRAIN_CLI_WARMUP = 1              # steps of a run left out of its times
# [train]: the kernel route's one-step losses and gradients against the
# plain route's. Both compute in bf16: the stem kernel rounds a few outputs
# a bf16 ulp apart from the plain stem, which moves everything after it
# slightly, and the plain backward of the FRM sample sums its scatter in
# bf16 (K2's backward in f32). Losses within 2% each; gradients within 5%
# relative L2 over all parameters, and each parameter's within 25% (a
# gradient that is wrong, not rounded otherwise, is off by its own size).
TRAIN_LOSS_RTOL = 0.02
TRAIN_GRAD_RTOL = 0.05
TRAIN_PARAM_RTOL = 0.25
# [ddp_*]: the global batch of the data-parallel step, split over its ranks;
# [ddp_step] shares card 0 between DDP_RANKS ranks over gloo
DDP_BATCH = 4
DDP_RANKS = 2
DDP_STEPS = 2
DDP_CLI_STEPS = (4, 6)            # the train CLI's run 1, then resumed to
DDP_TIMEOUT = 600                 # s: a phase's processes, a group's waits
# [ddp_eval]: seeded weights trained 6 steps score below the shipped 0.05
DDP_SCORE_THR = 0.005
INT8_QCONVS = 115                 # QConv launches of one int8 forward
R50_EPILOGUES = 48                # conv epilogues of one bf16 R50 forward
REPLACES = {
    'rotated_iou': 'r3det_tpu/ops/pallas_iou.py:146',
    'frm_sample': 'r3det_tpu/ops/frm_sample.py:241',
    # also the bf16 function of stem_conv_pool_pallas (:97) and
    # stem_conv_pool_pallas_grouped (:192)
    'stem_conv_pool': 'r3det_tpu/ops/stem_pool.py:586',
    'stem_conv_pool_q8': 'r3det_tpu/ops/stem_pool.py:586',
    'stem_pool': 'r3det_tpu/ops/stem_pool.py:430',
    'bottleneck': 'r3det_tpu/ops/bottleneck_fuse.py:206',
    'bottleneck_q8': 'r3det_tpu/ops/bottleneck_fuse.py:271',
    # no TPU kernel: the XLA int8 conv of QConv
    'int8_conv': 'r3det_tpu/models/quant.py:111',
    # no TPU kernel: XLA's scatter-add from autodiff of the FRM's gather
    'frm_sample_bwd': 'r3det_tpu/models/frm.py:27',
    # no TPU kernel: XLA fuses FrozenBN, ReLU and the residual into the conv
    'conv_epilogue': 'r3det_tpu/models/resnet.py:72',
    # no TPU kernel: the JAX package has no Swin
    'swin_norm_pad': 'none',
    'swin_window_attn': 'none',
    # no TPU kernel: XLA's blocked fixpoint sweep
    'nms_sweep': 'r3det_tpu/ops/nms.py:68',
    # no TPU kernel: the JAX package has no LSKNet
    'lsk_taps': 'none',
    'lsk_select': 'none',
    'lsk_bias_gelu': 'none',
    'lsk_bias_gate': 'none',
    'lsk_bias_residual': 'none',
    'lsk_dw_gelu': 'none',
    'lsk_bias_scale': 'none',
}
SOURCES = {
    'rotated_iou': 'r3det_tpu_torch/csrc/rotated_iou.cu',
    'frm_sample': 'r3det_tpu_torch/csrc/frm_sample.cu',
    'stem_conv_pool': 'r3det_tpu_torch/csrc/stem_pool.cu',
    'stem_conv_pool_q8': 'r3det_tpu_torch/csrc/stem_pool.cu',
    'stem_pool': 'r3det_tpu_torch/csrc/stem_pool.cu',
    'bottleneck': 'r3det_tpu_torch/csrc/bottleneck.cu',
    'bottleneck_q8': 'r3det_tpu_torch/csrc/bottleneck.cu',
    'int8_conv': 'r3det_tpu_torch/csrc/int8_conv.cu',
    'frm_sample_bwd': 'r3det_tpu_torch/csrc/frm_sample.cu',
    'conv_epilogue': 'r3det_tpu_torch/csrc/conv_epilogue.cu',
    'swin_norm_pad': 'r3det_tpu_torch/csrc/swin_attn.cu',
    'swin_window_attn': 'r3det_tpu_torch/csrc/swin_attn.cu',
    'nms_sweep': 'r3det_tpu_torch/csrc/nms_sweep.cu',
    'lsk_taps': 'r3det_tpu_torch/csrc/lsk_attn.cu',
    'lsk_select': 'r3det_tpu_torch/csrc/lsk_attn.cu',
    'lsk_bias_gelu': 'r3det_tpu_torch/csrc/lsk_attn.cu',
    'lsk_bias_gate': 'r3det_tpu_torch/csrc/lsk_attn.cu',
    'lsk_bias_residual': 'r3det_tpu_torch/csrc/lsk_attn.cu',
    'lsk_dw_gelu': 'r3det_tpu_torch/csrc/lsk_attn.cu',
    'lsk_bias_scale': 'r3det_tpu_torch/csrc/lsk_attn.cu',
}
# the run whose launch counts each kernel reports
PATH_OF = {'rotated_iou': 'bf16', 'frm_sample': 'bf16',
           'stem_conv_pool': 'bf16', 'stem_conv_pool_q8': 'int8',
           'stem_pool': 'route_bf16', 'bottleneck': 'route_bf16',
           'bottleneck_q8': 'route_int8', 'int8_conv': 'int8',
           'frm_sample_bwd': 'train', 'conv_epilogue': 'bf16',
           'swin_norm_pad': 'swin', 'swin_window_attn': 'swin',
           'nms_sweep': 'bf16', 'lsk_taps': 'lsk', 'lsk_select': 'lsk',
           'lsk_bias_gelu': 'lsk', 'lsk_bias_gate': 'lsk',
           'lsk_bias_residual': 'lsk', 'lsk_dw_gelu': 'lsk',
           'lsk_bias_scale': 'lsk'}
# the kernels each run must launch
PATH_KERNELS = {
    'bf16': ('rotated_iou', 'nms_sweep', 'frm_sample', 'stem_conv_pool',
             'conv_epilogue'),
    'int8': ('rotated_iou', 'nms_sweep', 'frm_sample', 'stem_conv_pool_q8',
             'int8_conv'),
    'route_bf16': ('stem_pool', 'bottleneck'),
    'route_int8': ('bottleneck_q8', 'stem_conv_pool_q8', 'int8_conv'),
    # an f32 model: every route takes its plain form but NMS's IoU and
    # sweep (f32)
    'f32': ('rotated_iou', 'nms_sweep'),
    # a train step: K3 (frozen stem), K1 (refine assignment), K2 and its
    # backward, once each
    'train': ('rotated_iou', 'frm_sample', 'frm_sample_bwd',
              'stem_conv_pool'),
    # a predict step with nms_candidates=8000: K1 once a streamed block
    'stream': ('rotated_iou', 'frm_sample', 'stem_conv_pool'),
    # R3Det* with frm_fuse_convs: the fused branch conv is cuDNN's
    'frm_fused': ('rotated_iou', 'frm_sample', 'stem_conv_pool'),
    # a train step of rotated RetinaNet with hbb_anchors: K1 in the rotated
    # assignment on hbb2obb anchors, K3 in the frozen stem
    'hbb_train': ('rotated_iou', 'stem_conv_pool'),
    # a bf16 Swin-T backbone forward: the attention kernels, once a block
    'swin': ('swin_norm_pad', 'swin_window_attn'),
    # a bf16 LSKNet-S backbone forward: the attention's and the MLP's
    # kernels, once a block
    'lsk': LSK_ATTN_KERNELS + LSK_MLP_KERNELS,
}


def phase(tag, **fields):
    print(f"[{tag}] " + ' '.join(f'{k}={v}' for k, v in fields.items()),
          flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def iou_main_path(k_boxes, vc, card):
    """K1 on the NMS candidates of a main-path predict step, against its
    plain version (bit-equal), timed, with its near-pair share."""
    import torch

    from r3det_tpu_torch.ops import rotated_iou as K1
    args = dict(upper_only=True, valid_count=vc)
    got = K1.rotated_iou_cuda(k_boxes, k_boxes, **args)
    want = K1.rotated_iou_reference(k_boxes, k_boxes, **args)
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: K1.rotated_iou_cuda(k_boxes, k_boxes, **args), 20)
    plain_ms = cuda_ms(
        lambda: K1.rotated_iou_reference(k_boxes, k_boxes, **args), 3)
    work = iou_work(k_boxes, vc, got)
    phase('kernel', name='rotated_iou', shape='main_path',
          candidates=str(tuple(k_boxes.shape)), valid=vc.tolist(),
          max_abs_err=err, tol=0.0, ms=f'{ms:.4f}',
          plain_ms=f'{plain_ms:.4f}', card=card,
          **{n: f'{v:.4f}' if isinstance(v, float) else v
             for n, v in work.items()})
    check(err == 0.0 and torch.equal(got, want),
          'rotated_iou disagrees with its plain version on the main path')


def nms_iou_inputs(fn):
    """Run ``fn()`` with NMS's IoU call recorded; returns its result and
    the (boxes, valid_count) of each K1 call it made."""
    from r3det_tpu_torch.ops import nms
    seen = []
    real = nms.rotated_iou

    def spy(boxes1, boxes2, **kw):
        seen.append((boxes1, kw['valid_count']))
        return real(boxes1, boxes2, **kw)
    nms.rotated_iou = spy
    try:
        return fn(), seen
    finally:
        nms.rotated_iou = real


# ---------------------------------------------------------------------------
# phase 3 inputs (numpy seeded, moved to the card)
# ---------------------------------------------------------------------------

def iou_boxes(rng, b, k):
    """Candidate-like boxes with identical, touching and parallel-edge
    pairs mixed in."""
    import numpy as np
    boxes = np.stack([rng.uniform(0, SIZE, (b, k)),
                      rng.uniform(0, SIZE, (b, k)),
                      rng.uniform(4, 160, (b, k)), rng.uniform(4, 160, (b, k)),
                      rng.uniform(-math.pi / 2, math.pi / 2, (b, k))], -1)
    n = k // 16
    boxes[:, 1:n:2] = boxes[:, 0:n - 1:2]                         # identical
    touch = boxes[:, n:2 * n:2].copy()                            # touching
    touch[..., 0] += touch[..., 2] * np.cos(touch[..., 4])
    touch[..., 1] += touch[..., 2] * np.sin(touch[..., 4])
    boxes[:, n + 1:2 * n:2] = touch[:, :boxes[:, n + 1:2 * n:2].shape[1]]
    par = boxes[:, 2 * n:3 * n:2].copy()                          # parallel
    par[..., 0] += 0.5 * par[..., 2] * np.cos(par[..., 4])
    par[..., 1] += 0.5 * par[..., 2] * np.sin(par[..., 4])
    boxes[:, 2 * n + 1:3 * n:2] = par[:, :boxes[:, 2 * n + 1:3 * n:2].shape[1]]
    return boxes.astype(np.float32)


def frm_rois(rng, b, h, w, stride):
    """Best boxes near their cells (as filter_bboxes gives them), some far
    off and some outside the image."""
    import numpy as np
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    cx = (jj * stride)[None] + rng.uniform(-2, 2, (b, h, w)) * stride
    cy = (ii * stride)[None] + rng.uniform(-2, 2, (b, h, w)) * stride
    far = rng.uniform(size=(b, h, w)) < 0.05
    cx = np.where(far, rng.uniform(-0.2 * SIZE, 1.2 * SIZE, (b, h, w)), cx)
    cy = np.where(far, rng.uniform(-0.2 * SIZE, 1.2 * SIZE, (b, h, w)), cy)
    rois = np.stack([cx, cy, rng.uniform(8, 128, (b, h, w)),
                     rng.uniform(8, 128, (b, h, w)),
                     rng.uniform(-1.5, 1.5, (b, h, w))], -1)
    return rois.reshape(b, h * w, 5).astype(np.float32)


def frm_collide_rois(rng, b):
    """Rois that send the centre of every cell of a level to one point
    (0.3, 0.6) of the map (transposed quirk: row <- cx, col <- cy), and a
    tenth of them to its clamped last row: corner rows of thousands of
    contributions for K2's backward."""
    import numpy as np
    rois = []
    for s in FRM_SIZES:
        stride, n = SIZE // s, s * s
        cx = np.full((b, n), 0.3 * s * stride)
        cy = np.full((b, n), 0.6 * s * stride)
        cx[rng.uniform(size=(b, n)) < 0.1] = (s - 0.5) * stride
        rois.append(np.stack([cx, cy, rng.uniform(8, 64, (b, n)),
                              rng.uniform(8, 64, (b, n)),
                              rng.uniform(-1.5, 1.5, (b, n))], -1)
                    .astype(np.float32))
    return rois


def frm_inputs(rng, dev, batch=BATCH):
    """K2's main-path inputs: the five levels' (x, feat, rois, scales) of
    ``batch`` images, bf16 x and feat of FRM_CHANNELS."""
    import numpy as np
    import torch
    xs, feats, rois, scales = [], [], [], []
    for s in FRM_SIZES:
        stride = SIZE // s
        shape = (batch, s, s, FRM_CHANNELS)
        for out in (xs, feats):
            out.append(torch.from_numpy(rng.randn(*shape).astype(
                np.float32)).to(dev, torch.bfloat16))
        rois.append(torch.from_numpy(frm_rois(rng, batch, s, s, stride)).to(
            dev))
        scales.append(1.0 / stride)
    return xs, feats, rois, scales


def bf16_ulp(v):
    """One bf16 ulp at |v| (f32 tensor; 0 at 0)."""
    import torch
    _, e = torch.frexp(v)
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.ldexp(torch.ones_like(v), e - 8))


def frm_bwd_check(got, grads, rois, scales, points):
    """K2's backward against its plain backward computed in f32 (autograd
    through frm_sample_levels_reference on f32 gradients) and rounded to
    bf16. Bound a value: one bf16 ulp of the f32 reference plus 2^-14 of
    the sum of its absolute contributions A (the plain backward of |g|):
    the kernel's ordered f32 sums and the plain scatter sum the same f32
    products in other orders. Returns (the largest excess over the bound,
    max |kernel - f32 reference|, max |kernel - bf16 plain backward|)."""
    from r3det_tpu_torch.ops import frm_sample as K2
    excess, err, gap = -math.inf, 0.0, 0.0
    for lvl in range(len(got)):
        args = ([rois[lvl]], [scales[lvl]], points)
        g = grads[lvl]
        ref = K2.frm_sample_levels_bwd_reference([g.float()], *args)[0]
        absum = K2.frm_sample_levels_bwd_reference([g.float().abs()],
                                                   *args)[0]
        plain = K2.frm_sample_levels_bwd_reference([g], *args)[0]
        k = got[lvl].float()
        slack = 2.0 ** -14 * absum
        tol = bf16_ulp(ref.abs() + slack) + slack
        d = (k - ref.to(grads[0].dtype).float()).abs()
        excess = max(excess, float((d - tol).max()))
        err = max(err, float((k - ref).abs().max()))
        gap = max(gap, float((k - plain.float()).abs().max()))
        del ref, absum, plain, k, slack, tol, d
    return excess, err, gap


def frm_bwd_segments(rois, scales, points, sizes):
    """The corner rows' contribution counts of K2's backward on these rois
    (every row of every level and image): mean, p99 and max."""
    import torch

    from r3det_tpu_torch.ops import frm_sample as K2
    counts = []
    for r, sc, (b, h, w) in zip(rois, scales, sizes):
        key, _ = K2.bwd_contributions(r, sc, h, w, points)
        counts.append(torch.bincount(key[key >= 0], minlength=b * h * w))
    c = torch.cat(counts).float()
    return (f'{float(c.mean()):.3f}', f'{float(c.quantile(0.99)):.0f}',
            int(c.max()))


def frm_bwd_kernel(dev, rng):
    """K2's backward at the training shapes (the five levels of a 1024^2
    image, TRAIN_BATCH, FRM_CHANNELS), points 1 (the recorded row) and 5:
    one launch for the five levels, bit for bit equal to its ordered plain
    form (frm_sample_levels_bwd_ordered on CPU copies), three launches
    bit for bit alike, within frm_bwd_check's bound; timed beside the plain
    bf16 backward (autograd of the plain forward), on colliding rois (every
    cell on one corner), and beside an f32 index_add_ of the precomputed
    weighted rows (scatter_only_ms: a comparison, no PyTorch call computes
    the function)."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.ops import frm_sample as K2
    xs, feats, rois, scales = frm_inputs(rng, dev, TRAIN_BATCH)
    grads = [torch.from_numpy(rng.randn(*f.shape).astype(np.float32)).to(
        dev, torch.bfloat16) for f in feats]
    collide = [torch.from_numpy(r).to(dev)
               for r in frm_collide_rois(rng, TRAIN_BATCH)]
    sizes = [tuple(g.shape[:3]) for g in grads]
    rec = None
    for points in (1, 5):
        trig = K2.angle_trig(rois) if points == 5 else None
        before = _ext.LAUNCHES['frm_sample_bwd']
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        got = K2.frm_sample_levels_bwd_cuda(grads, rois, scales, points,
                                            trig=trig)
        torch.cuda.synchronize()
        peak_mb = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        check(_ext.LAUNCHES['frm_sample_bwd'] == before + 1,
              'K2 backward: one launch for the five levels')
        want = K2.frm_sample_levels_bwd_ordered(
            [g.cpu() for g in grads], [r.cpu() for r in rois], scales,
            points, True, None if trig is None else trig.cpu())
        exact = all(torch.equal(k.cpu().view(torch.int16),
                                w.view(torch.int16))
                    for k, w in zip(got, want))
        err = max(float((k.cpu().float() - w.float()).abs().max())
                  for k, w in zip(got, want))
        del want
        same = all(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                       for a, b in zip(got, K2.frm_sample_levels_bwd_cuda(
                           grads, rois, scales, points, trig=trig)))
                   for _ in range(2))
        excess, err32, gap = frm_bwd_check(got, grads, rois, scales, points)
        del got
        ms = cuda_ms(lambda: K2.frm_sample_levels_bwd_cuda(
            grads, rois, scales, points, trig=trig), 20)
        ctrig = K2.angle_trig(collide) if points == 5 else None
        collide_ms = cuda_ms(lambda: K2.frm_sample_levels_bwd_cuda(
            grads, collide, scales, points, trig=ctrig), 5)
        # the plain backward alone: autograd of the plain bf16 forward,
        # its graph built once
        with torch.enable_grad():
            fs = [f.detach().requires_grad_() for f in feats]
            outs = K2.frm_sample_levels_reference(xs, fs, rois, scales,
                                                  points)
            plain_ms = cuda_ms(lambda: torch.autograd.grad(
                outs, fs, grads, retain_graph=True), 5)
        del fs, outs
        # an f32 scatter of the weighted rows, precomputed: the atomics
        # alone, no setup and no final add
        keys, rows, begin = [], [], 0
        for g, r, sc, (b, h, w) in zip(grads, rois, scales, sizes):
            key, wt = K2.bwd_contributions(
                r, sc, h, w, points, True,
                None if trig is None else
                trig[:, begin:begin + b * h * w].reshape(2, b, h * w))
            src = torch.arange(key.numel(), device=dev) // (4 * points)
            keep = key >= 0
            keys.append(key[keep] + begin)
            rows.append(wt[keep, None] * g.reshape(b * h * w, -1)[
                src[keep]].float())
            begin += b * h * w
        keys, rows = torch.cat(keys), torch.cat(rows)
        acc = torch.zeros(begin, rows.shape[1], device=dev)
        scatter_ms = cuda_ms(lambda: acc.index_add_(0, keys, rows), 5)
        contributions = keys.numel()
        del keys, rows, acc
        # g read and dfeat written (bf16), the rois (and trig) read; per
        # value points x 4 corners x (a product, a sum) and g + acc. The
        # workspace's own traffic, counted apart: a (corner row, weight)
        # slot and a CSR id a contribution slot (12 bytes)
        values = sum(g.numel() for g in grads)
        nbytes = 2 * values * 2 + sum(r.numel() for r in rois) * 4 + \
            (0 if trig is None else trig.numel() * 4)
        index_bytes = 12 * 4 * points * begin
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None)
        b_ms, by = add_bound(r, nbytes, values * (8 * points + 1), 'f32')
        mean, p99, top = frm_bwd_segments(rois, scales, points, sizes)
        cmean, cp99, ctop = frm_bwd_segments(collide, scales, points, sizes)
        phase('kernel', name='frm_sample_bwd', points=points,
              levels=str([tuple(g.shape) for g in grads]), launches_a_call=1,
              bit_equal_ordered=exact, max_abs_err=err, deterministic=same,
              f32_err=err32, bf16_autograd_gap=gap,
              tol='1 bf16 ulp + 2^-14 sum|w g|', excess=excess,
              ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              bound_ms=f'{b_ms:.4f}', bound_by=by,
              contributions=contributions, index_bytes=index_bytes,
              peak_mb=f'{peak_mb:.1f}', segments_mean=mean, segments_p99=p99,
              segments_max=top, collide_ms=f'{collide_ms:.4f}',
              collide_segments_mean=cmean, collide_segments_p99=cp99,
              collide_segments_max=ctop, scatter_only_ms=f'{scatter_ms:.4f}',
              library_ms=None)
        check(exact, f'frm_sample_bwd points={points} is not bit-equal to '
                     f'its ordered plain form')
        check(same, f'frm_sample_bwd points={points} is not deterministic')
        check(excess <= 0.0, f'frm_sample_bwd points={points} disagrees '
                             f'with its f32 plain backward')
        if points == 1:
            rec = r
    del xs, feats, rois, grads, collide
    torch.cuda.empty_cache()
    return rec


def compare_kernels(dev):
    """Phase 3: every kernel vs its plain version at main-path shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.ops import frm_sample as K2
    from r3det_tpu_torch.ops import rotated_iou as K1
    from r3det_tpu_torch.ops import stem_pool as K3

    rng = np.random.RandomState(SEED)
    rec = {}

    # K1: f32, the plain version's operations (and exact 0 for the pairs
    # it culls) -> bit-equal
    for k in IOU_BUDGETS:
        boxes = torch.from_numpy(iou_boxes(rng, BATCH, k)).to(dev)
        vc = torch.from_numpy(rng.randint(k // 4, k + 1, BATCH)
                              .astype(np.int32)).to(dev)
        vc[0] = k                                       # one full image
        args = dict(upper_only=True, valid_count=vc)
        got = K1.rotated_iou_cuda(boxes, boxes, **args)
        want = K1.rotated_iou_reference(boxes, boxes, **args)
        full = K1.rotated_iou_cuda(boxes, boxes)
        full_want = K1.rotated_iou_reference(boxes, boxes)
        err = max(float((got - want).abs().max()),
                  float((full - full_want).abs().max()))
        iof = K1.rotated_iou_cuda(boxes[:1], boxes[:1], mode='iof')
        iof_err = float((iof - K1.rotated_iou_reference(
            boxes[:1], boxes[:1], mode='iof')).abs().max())
        diag = float((torch.diagonal(full, dim1=1, dim2=2) - 1).abs().max())
        del full, full_want, iof, want
        ms = cuda_ms(lambda: K1.rotated_iou_cuda(boxes, boxes, **args), 20)
        plain_ms = cuda_ms(
            lambda: K1.rotated_iou_reference(boxes, boxes, **args), 3)
        work = iou_work(boxes, vc, got)
        phase('kernel', name='rotated_iou', shape=f'({BATCH},{k},{k})',
              max_abs_err=err, iof_err=iof_err, self_iou_err=diag,
              tol=0.0, ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              **{n: f'{v:.4f}' if isinstance(v, float) else v
                 for n, v in work.items()})
        check(err == 0.0 and iof_err == 0.0 and diag <= 1e-4,
              f'rotated_iou K={k} disagrees with its plain version')
        if k == IOU_BUDGETS[0]:
            rec['rotated_iou'] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms,
                                      bound_ms=work['bound_ms'],
                                      bound_by=work['bound_by'])
        del boxes, got
    torch.cuda.empty_cache()
    compare_nms_sweep(dev, rec)

    # K2: every level in one launch, bf16, the plain form's operations in
    # its order (the cos/sin of the angles by PyTorch) -> bit-equal
    xs, feats, rois, scales = frm_inputs(rng, dev)
    for points in (1, 5):
        got = K2.frm_sample_levels_cuda(xs, feats, rois, scales, points)
        want = K2.frm_sample_levels_reference(xs, feats, rois, scales, points)
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        del got, want
        # the kernel alone (its arguments built once; points=5's cos/sin
        # taken once), and the whole call (checks, outputs, cos/sin)
        outs = [torch.empty_like(f) for f in feats]
        largs = K2.levels_args(xs, feats, rois, outs, scales,
                               K2.angle_trig(rois) if points == 5 else None,
                               points, True)
        ms = cuda_ms(lambda: _ext.launch('frm_sample_levels', *largs), 20)
        wrapper_ms = cuda_ms(lambda: K2.frm_sample_levels_cuda(
            xs, feats, rois, scales, points), 20)
        plain_ms = cuda_ms(lambda: K2.frm_sample_levels_reference(
            xs, feats, rois, scales, points), 5)
        del outs, largs
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        b_ms, by = add_bound(r, *frm_work(xs, rois, points), 'f32')
        phase('kernel', name='frm_sample', points=points,
              levels=str([tuple(f.shape) for f in feats]), launches_a_call=1,
              bit_equal=equal, max_abs_err=err, tol=0.0, ms=f'{ms:.4f}',
              wrapper_ms=f'{wrapper_ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              bound_ms=f'{b_ms:.4f}', bound_by=by)
        check(equal and err == 0.0,
              f'frm_sample points={points} disagrees with its plain version')
        if points == 1:
            rec['frm_sample'] = r
    del xs, feats, rois
    torch.cuda.empty_cache()

    # K3, bf16 and int8: the kernel alone, on weights packed once (as the
    # model packs them) and, in int8, max|x| taken once; wrapper_ms times
    # the whole call with the packing (and max|x|) in it, for comparison
    # with timings taken that way
    x12 = torch.from_numpy(rng.uniform(-2, 2, (BATCH, SIZE // 2, SIZE // 2, 12))
                           .astype(np.float32)).to(dev, torch.bfloat16)
    kern = torch.from_numpy(rng.normal(0, 0.1, (4, 4, 12, 64))
                            .astype(np.float32)).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 2, 64).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)).to(dev)
    amax = K3.abs_max(x12)
    amax_ms = cuda_ms(lambda: K3.abs_max(x12), 20)
    # the folded 4x4x12 conv at every s2d pixel; image in, pooled map out
    stem_ops = 2 * x12.shape[0] * x12.shape[1] * x12.shape[2] * 192 * 64
    for name, q8 in (('stem_conv_pool', False), ('stem_conv_pool_q8', True)):
        pack = K3.pack_stem(kern, scale, bias, quantize=q8)
        plain = K3.stem_conv_pool_q8_reference if q8 else \
            K3.stem_conv_pool_reference
        got = K3.stem_conv_pool_cuda(x12, pack, amax if q8 else None)
        want = plain(x12, kern, scale, bias)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ms = cuda_ms(lambda: K3.stem_conv_pool_cuda(
            x12, pack, amax if q8 else None), 50)
        wrapper_ms = cuda_ms(lambda: K3.stem_conv_pool(
            x12, kern, scale, bias, quantize=q8), 20)
        plain_ms = cuda_ms(lambda: plain(x12, kern, scale, bias), 5)
        stem_bytes = x12.numel() * 2 + kern.numel() * 4 + got.numel() * 2
        rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        b_ms, by = add_bound(rec[name], stem_bytes, stem_ops,
                             'int8' if q8 else 'bf16')
        extra = dict(amax_ms=f'{amax_ms:.4f}') if q8 else {}
        phase('kernel', name=name, shape=str(tuple(got.shape)),
              max_abs_err=err, exact_frac=float((diff == 0).float().mean()),
              tol=0.0 if q8 else '1e-2 + 1e-2*|ref|', ms=f'{ms:.4f}',
              wrapper_ms=f'{wrapper_ms:.4f}', **extra,
              plain_ms=f'{plain_ms:.4f}', bound_ms=f'{b_ms:.4f}',
              bound_by=by)
        if q8:
            # exact int32 sums and the plain version's epilogue in its order
            check(err == 0.0, f'{name} disagrees with its plain version')
        else:
            # f32 sums in another order -> atol 1e-2 + rtol 1e-2
            check(bool((diff <= 1e-2 + 1e-2 * want.float().abs()).all()),
                  f'{name} disagrees with its plain version')
        del got, want, diff

    # K4 on the plain conv output of the same stem: a max, bit-equal
    conv = torch.from_numpy(rng.uniform(0, 4, (BATCH, SIZE // 2, SIZE // 2,
                                               64)).astype(np.float32)).to(
        dev, torch.bfloat16)
    got = K3.stem_pool_cuda(conv)
    err = float((got.float() - K3.stem_pool_reference(conv).float())
                .abs().max())
    ms = cuda_ms(lambda: K3.stem_pool_cuda(conv), 20)
    plain_ms = cuda_ms(lambda: K3.stem_pool_reference(conv), 5)
    # the library call of the same function: max_pool2d on the
    # channels_last bf16 map (-inf padding, as the kernel)
    conv_nchw = conv.permute(0, 3, 1, 2)
    lib_out = F.max_pool2d(conv_nchw, 3, 2, 1).permute(0, 2, 3, 1)
    lib_err = float((lib_out.float() - got.float()).abs().max())
    library_ms = cuda_ms(lambda: F.max_pool2d(conv_nchw, 3, 2, 1), 20)
    rec['stem_pool'] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms)
    b_ms, by = add_bound(rec['stem_pool'], conv.numel() * 2 + got.numel() * 2,
                         9 * got.numel(), 'f32')
    phase('kernel', name='stem_pool', shape=str(tuple(got.shape)),
          max_abs_err=err, tol=0.0, ms=f'{ms:.4f}',
          plain_ms=f'{plain_ms:.4f}', library_ms=f'{library_ms:.4f}',
          library_err=lib_err, bound_ms=f'{b_ms:.4f}', bound_by=by)
    check(err == 0.0, 'stem_pool disagrees with its plain version')
    del conv, conv_nchw, lib_out
    rec.update(compare_bottlenecks(dev, rng))
    rec['conv_epilogue'] = compare_epilogue(dev, rng)
    rec.update(compare_swin(dev, rng))
    rec.update(compare_lsk(dev, rng))
    rec.update(compare_lsk_mlp(dev, rng))
    rec['int8_conv'] = int8_conv_route(dev, rng)
    rec['frm_sample_bwd'] = frm_bwd_kernel(dev, rng)
    return rec


def same_bits(got, want):
    """bf16 tensors equal bit for bit, NaN where NaN."""
    import torch
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(
        got[~nan].view(torch.int16), want[~nan].view(torch.int16))


def sweep_scene(rng, dev, k, live):
    """The NMS sweep's arguments (iou, valid, labels, vcount, iou_thr) on
    the card for one of SWEEP_SCENES: K1's upper_only IoU of ``iou_boxes``
    candidates, SWEEP_LABELS labels, a live prefix of ``live`` (low, high)
    an image with v3 holes in it."""
    import numpy as np
    import torch

    from r3det_tpu_torch.ops import rotated_iou as K1
    vcount = rng.randint(live[0], live[1] + 1, BATCH)
    valid = (np.arange(k)[None] < vcount[:, None]) \
        & (rng.uniform(size=(BATCH, k)) > 0.03)
    boxes = torch.from_numpy(iou_boxes(rng, BATCH, k)).to(dev)
    vc = torch.from_numpy(vcount.astype(np.int32)).to(dev)
    iou = K1.rotated_iou(boxes, boxes, upper_only=True, valid_count=vc)
    labels = torch.from_numpy(rng.randint(0, SWEEP_LABELS, (BATCH, k)))
    return iou, torch.from_numpy(valid).to(dev), labels.to(dev), vc, 0.1


def compare_nms_sweep(dev, rec):
    """The NMS sweep kernel against its plain route (the gate and the
    blocked fixpoint, host syncs and all) on SWEEP_SCENES: the same keep
    set, timed; the dense scene's line is the kernel's record."""
    import numpy as np
    import torch

    from r3det_tpu_torch.ops import nms
    rng = np.random.RandomState(SEED)
    for k, live in SWEEP_SCENES:
        args = sweep_scene(rng, dev, k, live)
        got = nms.greedy_keep_gated_cuda(*args)
        equal = torch.equal(got, nms.greedy_keep_gated_reference(*args))
        ms = cuda_ms(lambda: nms.greedy_keep_gated_cuda(*args), 20)
        plain_ms = cuda_ms(lambda: nms.greedy_keep_gated_reference(*args), 3)
        work = nms_sweep_work(args[2].cpu(), args[3].cpu())
        phase('kernel', name='nms_sweep', shape=f'({BATCH},{k})',
              live=args[1].sum(1).tolist(), kept=got.sum(1).tolist(),
              bit_equal=equal, ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              **{n: f'{v:.4f}' if isinstance(v, float) else v
                 for n, v in work.items()})
        check(equal, f'nms_sweep K={k} keeps another set than its plain '
                     'route')
        if k == SWEEP_SCENES[0][0]:
            rec['nms_sweep'] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                    bound_ms=work['bound_ms'],
                                    bound_by=work['bound_by'])
        del got, args
    torch.cuda.empty_cache()


def compare_epilogue(dev, rng):
    """The conv epilogue at each distinct shape of a ResNet-50 predict
    step (batch 8 of 1024^2): bit-equal to its plain form and to the
    unfused PyTorch passes of ``Bottleneck.forward`` it replaces. ``ms`` is
    a launch's device time (a CUDA graph of launches over enough buffers
    that L2 holds none of a round's), ``call_ms`` a call through the
    wrapper (paced by the host for the small shapes), ``unfused_ms`` the
    passes it replaces; the record sums each shape's over its launches a
    step."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from r3det_tpu_torch.ops import conv_epilogue as E

    bf16 = torch.bfloat16
    calls = r50_epilogues(BATCH, SIZE)
    counts = {}
    for call in calls:
        counts[call] = counts.get(call, 0) + 1
    rec = dict(max_abs_err=0.0, ms=0.0, call_ms=0.0, plain_ms=0.0,
               unfused_ms=0.0)

    def tensor(shape, std=1.0):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(dev, bf16).contiguous(
                memory_format=torch.channels_last)

    def affine(c):
        return tuple(torch.from_numpy(v.astype(np.float32)).to(dev, bf16)
                     for v in (rng.uniform(0.5, 1.5, c), rng.normal(0, .1, c)))

    def unfused(a, inv, b, residual):
        # Bottleneck.forward's passes: FrozenBN.forward, the residual add
        # (the downsample's FrozenBN first), F.relu
        def bn(x, s, t):
            return x * s.view(1, -1, 1, 1) + t.view(1, -1, 1, 1)
        y = bn(a, inv, b)
        if isinstance(residual, tuple):
            y = y + bn(*residual)
        elif residual is not None:
            y = y + residual
        return F.relu(y)

    def operands(shape, kind):
        c = shape[1]
        return (tensor(shape), *affine(c), None if kind is None else
                tensor(shape) if kind == 'identity' else
                (tensor(shape), *affine(c)))

    for (shape, kind), n in counts.items():
        nbytes = epilogue_bytes(shape, kind)
        sets = [operands(shape, kind)
                for _ in range(max(2, math.ceil(120e6 / nbytes)))]
        a, inv, b, residual = sets[0]
        want = E.conv_epilogue_reference(a, inv, b, residual)
        got = E.conv_epilogue_cuda(a.clone(), inv, b, residual)
        exact = same_bits(got, want) and same_bits(
            unfused(a, inv, b, residual), want)
        err = float((got.float() - want.float()).abs().max())
        del got, want
        check(exact, f'conv_epilogue at {shape} ({kind}) is not bit-equal '
                     'to its plain form and the unfused passes')
        ms = graph_ms([lambda s=s: E.conv_epilogue_cuda(*s) for s in sets],
                      max(len(sets), 24 // len(sets) * len(sets)))
        call_ms = cuda_ms(lambda: E.conv_epilogue_cuda(*sets[0]), 20)
        unfused_ms = cuda_ms(lambda: unfused(*sets[0]), 10)
        plain_ms = cuda_ms(lambda: E.conv_epilogue_reference(*sets[0]), 3)
        b_ms, by = add_bound({}, nbytes, 0, 'bf16')
        phase('kernel', name='conv_epilogue', shape=str(shape),
              residual=kind, launches_per_step=n, exact=exact,
              ms=f'{ms:.4f}', call_ms=f'{call_ms:.4f}',
              unfused_ms=f'{unfused_ms:.4f}', plain_ms=f'{plain_ms:.4f}',
              bound_ms=f'{b_ms:.4f}', bound_by=by,
              bound_share=f'{b_ms / ms:.3f}',
              gb_per_s=f'{nbytes / ms / 1e6:.1f}')
        rec['max_abs_err'] = max(rec['max_abs_err'], err)
        for k, v in (('ms', ms), ('call_ms', call_ms),
                     ('plain_ms', plain_ms), ('unfused_ms', unfused_ms)):
            rec[k] += n * v
        add_bound(rec, n * nbytes, 0, 'bf16')
        del a, residual, sets
    phase('kernel_sum', name='conv_epilogue', launches=len(calls),
          ms=f'{rec["ms"]:.4f}', call_ms=f'{rec["call_ms"]:.4f}',
          unfused_ms=f'{rec["unfused_ms"]:.4f}',
          plain_ms=f'{rec["plain_ms"]:.4f}',
          bound_ms=f'{rec["bound_ms"]:.4f}',
          bound_share=f'{rec["bound_ms"] / rec["ms"]:.3f}')
    torch.cuda.empty_cache()
    return rec


def compare_swin(dev, rng):
    """Swin's two attention kernels at Swin-T's four stage shapes of a
    batch of 8 1024^2 images, against their plain forms on the card at the
    card tests' tolerances: ``swin_norm_pad`` within one bf16 ulp (2^-7
    relative: the two sum the mean and variance in other orders) and its
    pad zeros; ``swin_window_attn``, unshifted and shifted, within one
    bf16 ulp plus 2^-8 max|v| (a P rounded to the neighbouring bf16). Each
    beside its plain form's time and its bound (``swin_attn_work``); the
    records sum each shape's over its launches a forward (12 each)."""
    import numpy as np
    import torch

    from r3det_tpu_torch.models.swin import SwinBlock, padded
    from r3det_tpu_torch.ops import swin_attn as A

    win = SWIN_WINDOW
    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
            for k in PATH_KERNELS['swin']}

    def normal(shape, std, mean=0.0):
        return torch.from_numpy(rng.normal(mean, std, shape).astype(
            np.float32)).to(dev)

    def within(got, want, atol):
        diff = (got.float() - want.float()).abs()
        return float(diff.max()), bool(
            (diff <= 2 ** -7 * want.float().abs() + atol).all())

    def record(name, n, err, ms, plain_ms, bound_ms, by):
        rec = recs[name]
        rec['max_abs_err'] = max(rec['max_abs_err'], err)
        rec['ms'] += n * ms
        rec['plain_ms'] += n * plain_ms
        add_bound_ms(rec, n * bound_ms, by)

    for side, c, heads, depth in SWIN_STAGES:
        hp = padded(side, win)
        x = normal((BATCH, side, side, c), 1.0).to(torch.bfloat16)
        gain, shift = normal((c,), 0.5, 1.0), normal((c,), 0.5)
        msa = SwinBlock(c, heads, 4 * c, win, True).to(dev).attn.w_msa
        table = msa.relative_position_bias_table
        with torch.no_grad():
            msa.qkv.weight.copy_(normal(msa.qkv.weight.shape, c ** -0.5))
            msa.qkv.bias.copy_(normal((3 * c,), 0.1))
            table.copy_(normal(table.shape, 1.0))
        work = swin_attn_work(BATCH, side, side, c, heads, win)
        with torch.no_grad():
            def norm(fn):
                return fn(x, gain, shift, 1e-5, hp, hp)
            got = norm(A.norm_pad_cuda)
            err, ok = within(got, norm(A.norm_pad_reference), 1e-5)
            ok = ok and not got[:, side:].any() and not got[:, :, side:].any()
            ms = cuda_ms(lambda: norm(A.norm_pad_cuda), 20)
            plain_ms = cuda_ms(lambda: norm(A.norm_pad_reference), 5)
            b_ms, by = work['swin_norm_pad']
            phase('kernel', name='swin_norm_pad', shape=str(tuple(got.shape)),
                  launches_per_forward=depth, max_abs_err=err,
                  tol='2^-7*|ref| + 1e-5', ms=f'{ms:.4f}',
                  plain_ms=f'{plain_ms:.4f}', bound_ms=f'{b_ms:.4f}',
                  bound_by=by, bound_share=f'{b_ms / ms:.3f}')
            check(ok, f'swin_norm_pad at {tuple(x.shape)} disagrees with its '
                      'plain form')
            record('swin_norm_pad', depth, err, ms, plain_ms, b_ms, by)
            qkv = msa.qkv(got)
            del got
            vmax = float(qkv[..., 2 * c:].float().abs().max())
            for s in (0, win // 2):
                def attn(fn):
                    return fn(qkv, table, heads, win, s, side, side)
                got = attn(A.window_attn_cuda)
                err, ok = within(got, attn(A.window_attn_reference),
                                 2 ** -8 * vmax)
                ms = cuda_ms(lambda: attn(A.window_attn_cuda), 20)
                plain_ms = cuda_ms(lambda: attn(A.window_attn_reference), 3)
                b_ms, by = work['swin_window_attn']
                phase('kernel', name='swin_window_attn',
                      shape=str(tuple(qkv.shape)), heads=heads, shift=s,
                      launches_per_forward=depth // 2, max_abs_err=err,
                      tol=f'2^-7*|ref| + 2^-8*{vmax:.3f}', ms=f'{ms:.4f}',
                      plain_ms=f'{plain_ms:.4f}', bound_ms=f'{b_ms:.4f}',
                      bound_by=by, bound_share=f'{b_ms / ms:.3f}')
                check(ok, f'swin_window_attn at {tuple(qkv.shape)} (shift '
                          f'{s}) disagrees with its plain form')
                record('swin_window_attn', depth // 2, err, ms, plain_ms,
                       b_ms, by)
                del got
        del x, qkv, msa, table
        torch.cuda.empty_cache()
    for name, rec in recs.items():
        phase('kernel_sum', name=name, launches=SWIN_BLOCKS,
              ms=f'{rec["ms"]:.4f}', plain_ms=f'{rec["plain_ms"]:.4f}',
              bound_ms=f'{rec["bound_ms"]:.4f}',
              bound_share=f'{rec["bound_ms"] / rec["ms"]:.3f}')
    return recs


def compare_lsk(dev, rng):
    """LSKNet's five attention kernels at LSKNet-S's four stage shapes of a
    batch of 8 1024^2 images, on a block seeded from ``rng`` (every bias
    and BN drawn wide) and inputs that are the real products of the
    route, each against its plain form on the card at the card tests'
    tolerances: ``lsk_taps``' a1 within one bf16 ulp plus 2^-16 of its
    taps' summed magnitude, a2 the same against the plain dilated taps of
    the kernel's a1; ``lsk_select`` within one bf16 ulp plus 2^-8 (|b1| +
    |b2|); the gate and the residual bit for bit, GELU within one bf16
    ulp. ``ms`` is a launch's device time in a CUDA graph (a map of 8 MB
    or less stays in L2 between launches: stage 4 is warm), beside its
    plain form's and its bound (``lsk_attn_work``, from the least work of
    ``portbench/work/lsknet.py``: 74 taps a channel on the CUDA cores, the
    bytes at 3.35 TB/s). ``[kernel] name=lsk_attention`` times the whole
    sub-block on the route (the four products included) against the eager
    bf16 sub-block; the records and ``[kernel_sum]`` sum each shape's over
    its launches a forward (10 each)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from portbench.work import lsknet as W
    from r3det_tpu_torch.models.lsknet import Block
    from r3det_tpu_torch.ops import lsk_attn as L
    from r3det_tpu_torch.ops.route import kernels

    bf16 = torch.bfloat16
    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
            for k in LSK_ATTN_KERNELS}
    whole = dict(ms=0.0, eager_ms=0.0, bound_ms=0.0)

    def normal(shape, std, mean=0.0):
        return torch.from_numpy(rng.normal(mean, std, shape).astype(
            np.float32)).to(dev)

    def within(got, want, atol):
        diff = (got.float() - want.float()).abs()
        return float(diff.max()), bool(
            (diff <= 2 ** -7 * want.float().abs() + atol).all())

    def record(name, n, err, ok, ms, plain_ms, bound, shape, tol):
        b_ms, by = bound
        phase('kernel', name=name, shape=str(shape), launches_per_forward=n,
              max_abs_err=err, tol=tol, ms=f'{ms:.4f}',
              plain_ms=f'{plain_ms:.4f}', bound_ms=f'{b_ms:.4f}',
              bound_by=by, bound_share=f'{b_ms / ms:.3f}')
        check(ok, f'{name} at {shape} disagrees with its plain form')
        rec = recs[name]
        rec['max_abs_err'] = max(rec['max_abs_err'], err)
        rec['ms'] += n * ms
        rec['plain_ms'] += n * plain_ms
        add_bound_ms(rec, n * b_ms, by)

    for side, c, depth in LSK_STAGES:
        block = Block(c, 4).to(dev).to(memory_format=torch.channels_last)
        with torch.no_grad():
            for name, prm in block.named_parameters():
                prm.copy_(normal(prm.shape, prm[0].numel() ** -0.5)
                          if prm.dim() > 1 else
                          normal(prm.shape, 0.5, 1.0 if 'norm1.weight' in name
                                 or 'layer_scale' in name else 0.0))
            block.norm1.running_mean.copy_(normal((c,), 1.0))
            block.norm1.running_var.copy_(normal((c,), 0.2, 1.0).abs())
            p = block.attn_pack(bf16)
        work = lsk_attn_work(BATCH, side, side, c)
        x = normal((BATCH, c, side, side), 1.0).to(bf16).contiguous(
            memory_format=torch.channels_last)
        xh = x.permute(0, 2, 3, 1)
        with torch.no_grad():
            v = F.linear(xh, p.w1)
            want = L.bias_gelu_reference(v, p.b1)
            got = L.bias_gelu_cuda(v.clone(), p.b1)
            err, ok = within(got, want, 0.0)
            record('lsk_bias_gelu', depth, err, ok,
                   graph_ms([lambda: L.bias_gelu_cuda(v, p.b1)], 20),
                   cuda_ms(lambda: L.bias_gelu_reference(v, p.b1), 3),
                   work['lsk_bias_gelu'], tuple(v.shape), '2^-7*|ref|')
            v = got
            got = L.taps_cuda(v, p.taps, p.b0, p.bs)
            want = L.taps_reference(v, p.taps, p.b0, p.bs)
            w0 = p.taps[:25].t().reshape(c, 1, 5, 5)
            ws = p.taps[25:].t().reshape(c, 1, 7, 7)
            a1 = got[..., :c].permute(0, 3, 1, 2).float().contiguous()
            mag0 = F.conv2d(v.permute(0, 3, 1, 2).float().abs(), w0.abs(),
                            p.b0.abs(), padding=2, groups=c)
            err1, ok1 = within(got[..., :c], want[..., :c],
                               2 ** -16 * mag0.permute(0, 2, 3, 1))
            del mag0
            want2 = F.conv2d(a1, ws, p.bs, padding=9, dilation=3, groups=c)
            mag1 = F.conv2d(a1.abs(), ws.abs(), p.bs.abs(), padding=9,
                            dilation=3, groups=c)
            err2, ok2 = within(got[..., c:], want2.permute(0, 2, 3, 1),
                               2 ** -16 * mag1.permute(0, 2, 3, 1))
            del a1, want2, mag1, want
            record('lsk_taps', depth, max(err1, err2), ok1 and ok2,
                   graph_ms([lambda: L.taps_cuda(v, p.taps, p.b0, p.bs)],
                            10),
                   cuda_ms(lambda: L.taps_reference(v, p.taps, p.b0, p.bs),
                           3),
                   work['lsk_taps'], tuple(v.shape),
                   '2^-7*|ref| + 2^-16*sum|w*v|')
            b = F.linear(got, p.w12)
            del got
            want = L.select_reference(b, p.b12, p.wq, p.bq)
            got = L.select_cuda(b, p.b12, p.wq, p.bq)
            bb = (b + p.b12.to(bf16)).float().abs()
            err, ok = within(got, want, 2 ** -8 * (bb[..., :c // 2]
                                                   + bb[..., c // 2:]))
            del bb, want
            record('lsk_select', depth, err, ok,
                   graph_ms([lambda: L.select_cuda(b, p.b12, p.wq, p.bq)],
                            20),
                   cuda_ms(lambda: L.select_reference(b, p.b12, p.wq, p.bq),
                           3),
                   work['lsk_select'], tuple(b.shape),
                   '2^-7*|ref| + 2^-8*(|b1| + |b2|)')
            a = F.linear(got, p.w3)
            want = L.bias_gate_reference(a, p.b3, v)
            got = L.bias_gate_cuda(a.clone(), p.b3, v)
            record('lsk_bias_gate', depth,
                   float((got.float() - want.float()).abs().max()),
                   same_bits(got, want),
                   graph_ms([lambda: L.bias_gate_cuda(a, p.b3, v)], 20),
                   cuda_ms(lambda: L.bias_gate_reference(a, p.b3, v), 3),
                   work['lsk_bias_gate'], tuple(a.shape), 0.0)
            a = F.linear(got, p.w2)
            args = (p.b2, xh, p.inv, p.shift, p.ls)
            want = L.bias_residual_reference(a, *args)
            got = L.bias_residual_cuda(a.clone(), *args)
            record('lsk_bias_residual', depth,
                   float((got.float() - want.float()).abs().max()),
                   same_bits(got, want),
                   graph_ms([lambda: L.bias_residual_cuda(a, *args)], 20),
                   cuda_ms(lambda: L.bias_residual_reference(a, *args), 3),
                   work['lsk_bias_residual'], tuple(a.shape), 0.0)
            del a, got, want, v, b

            def eager():
                return torch.addcmul(x, block.layer_scale_1.to(bf16).view(
                    1, -1, 1, 1), block.attn(block.norm1(x)))
            ms = cuda_ms(lambda: L.attention(x, p), 10)
            with kernels(False):
                eager_ms = cuda_ms(eager, 3)
        act, weights, tensor, f32 = W.attn_work(c)
        n = BATCH * side * side
        least = max(W.times((n * act + weights, n * tensor, n * f32))) * 1e3
        phase('kernel', name='lsk_attention', shape=str(tuple(x.shape)),
              launches_per_forward=depth, ms=f'{ms:.4f}',
              eager_ms=f'{eager_ms:.4f}', bound_ms=f'{least:.4f}',
              bound_share=f'{least / ms:.3f}')
        whole['ms'] += depth * ms
        whole['eager_ms'] += depth * eager_ms
        whole['bound_ms'] += depth * least
        del x, xh, block, p
        torch.cuda.empty_cache()
    for name, rec in recs.items():
        phase('kernel_sum', name=name, launches=LSK_BLOCKS,
              ms=f'{rec["ms"]:.4f}', plain_ms=f'{rec["plain_ms"]:.4f}',
              bound_ms=f'{rec["bound_ms"]:.4f}',
              bound_share=f'{rec["bound_ms"] / rec["ms"]:.3f}')
    phase('kernel_sum', name='lsk_attention', launches=LSK_BLOCKS,
          ms=f'{whole["ms"]:.4f}', eager_ms=f'{whole["eager_ms"]:.4f}',
          bound_ms=f'{whole["bound_ms"]:.4f}',
          bound_share=f'{whole["bound_ms"] / whole["ms"]:.3f}')
    return recs



def compare_lsk_mlp(dev, rng):
    """LSKNet's two MLP kernels at LSKNet-S's four stage shapes of a batch
    of 8 1024^2 images (hidden 512, 1024, 1280, 2048), on a block seeded
    from ``rng`` (every bias and BN drawn wide) and inputs that are the
    route's own products, each against its plain form on the card:
    ``lsk_dw_gelu`` within one bf16 ulp plus 2^-16 of what it sums, in
    magnitude (its taps sum in another order, fc1's bias split off);
    ``lsk_bias_scale`` bit for bit. ``ms`` as ``compare_lsk``'s, beside
    the plain form's and the bound (``lsk_mlp_work``: bytes at 3.35 TB/s).
    ``[kernel] name=lsk_mlp`` times the whole sub-block on the route
    against the eager bf16 sub-block, beside its two products' ms (cuBLAS,
    a CUDA graph), its least time (``portbench/work/lsknet.py``) and each
    route's error against the block in float32 (relative to the
    sub-block's contribution); the records and ``[kernel_sum]`` sum each
    shape's over its launches a forward (10 each)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from portbench.work import lsknet as W
    from r3det_tpu_torch.models.lsknet import Block
    from r3det_tpu_torch.ops import lsk_mlp as M
    from r3det_tpu_torch.ops.route import kernels

    bf16 = torch.bfloat16
    recs = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
            for k in LSK_MLP_KERNELS}
    whole = dict(ms=0.0, eager_ms=0.0, fc1_ms=0.0, fc2_ms=0.0, bound_ms=0.0)

    def normal(shape, std, mean=0.0):
        return torch.from_numpy(rng.normal(mean, std, shape).astype(
            np.float32)).to(dev)

    for (side, c, depth), ratio in zip(LSK_STAGES, LSK_RATIOS):
        hidden = c * ratio
        block = Block(c, ratio).to(dev).to(memory_format=torch.channels_last)
        with torch.no_grad():
            for name, prm in block.named_parameters():
                prm.copy_(normal(prm.shape, prm[0].numel() ** -0.5)
                          if prm.dim() > 1 else
                          normal(prm.shape, 0.5, 1.0 if 'norm2.weight' in name
                                 or 'layer_scale' in name else 0.0))
            block.norm2.running_mean.copy_(normal((c,), 1.0))
            block.norm2.running_var.copy_(normal((c,), 0.2, 1.0).abs())
            p = block.mlp_pack(bf16)
        work = lsk_mlp_work(BATCH, side, side, c, hidden)
        x = normal((BATCH, c, side, side), 1.0).to(bf16).contiguous(
            memory_format=torch.channels_last)
        xh = x.permute(0, 2, 3, 1)
        with torch.no_grad():
            h = F.linear(xh, p.w1)
            got = M.dw_gelu_cuda(h, p.b1, p.taps, p.bd)
            want = M.dw_gelu_reference(h, p.b1, p.taps, p.bd)
            wa = p.taps.abs()
            b1 = p.b1.float().abs()
            mag = F.conv2d((h.float().abs() + b1).permute(0, 3, 1, 2),
                           wa.t().reshape(hidden, 1, 3, 3),
                           b1 * wa.sum(0) + p.bd.abs(), padding=1,
                           groups=hidden).permute(0, 2, 3, 1)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            ok = bool((diff <= 2 ** -7 * want.float().abs()
                       + 2 ** -16 * mag).all())
            del mag, diff, want
            ms = graph_ms([lambda: M.dw_gelu_cuda(h, p.b1, p.taps, p.bd)],
                          20)
            plain_ms = cuda_ms(
                lambda: M.dw_gelu_reference(h, p.b1, p.taps, p.bd), 3)
            records = [('lsk_dw_gelu', err, ok, ms, plain_ms, tuple(h.shape),
                        '2^-7*|ref| + 2^-16*sum|w*(h+b1)|')]
            fc1_ms = graph_ms([lambda: F.linear(xh, p.w1)], 20)
            fc2_ms = graph_ms([lambda: F.linear(got, p.w2)], 20)
            a = F.linear(got, p.w2)
            want = M.bias_scale_reference(a, p.b2, xh, p.ls)
            res = M.bias_scale_cuda(a.clone(), p.b2, xh, p.ls)
            records.append((
                'lsk_bias_scale', float((res.float() - want.float()).abs()
                                        .max()),
                same_bits(res, want),
                graph_ms([lambda: M.bias_scale_cuda(a, p.b2, xh, p.ls)], 20),
                cuda_ms(lambda: M.bias_scale_reference(a, p.b2, xh, p.ls),
                        3), tuple(a.shape), 0.0))
            del h, got, a, want, res

            def eager(t):
                return torch.addcmul(t, block.layer_scale_2.to(t.dtype).view(
                    1, -1, 1, 1), block.mlp(block.norm2(t)))
            want = eager(x.float())
            spread = (want - x.float()).norm()
            errs = [float((M.mlp(x, p).float() - want).norm() / spread)]
            route_ms = cuda_ms(lambda: M.mlp(x, p), 10)
            with kernels(False):
                errs.append(float((eager(x).float() - want).norm() / spread))
                eager_ms = cuda_ms(lambda: eager(x), 3)
            del want
        for name, err, ok, ms, plain_ms, shape, tol in records:
            b_ms, by = work[name]
            phase('kernel', name=name, shape=str(shape),
                  launches_per_forward=depth, max_abs_err=err, tol=tol,
                  ms=f'{ms:.4f}', plain_ms=f'{plain_ms:.4f}',
                  bound_ms=f'{b_ms:.4f}', bound_by=by,
                  bound_share=f'{b_ms / ms:.3f}')
            check(ok, f'{name} at {shape} disagrees with its plain form')
            rec = recs[name]
            rec['max_abs_err'] = max(rec['max_abs_err'], err)
            rec['ms'] += depth * ms
            rec['plain_ms'] += depth * plain_ms
            add_bound_ms(rec, depth * b_ms, by)
        act, weights, tensor, f32 = W.mlp_work(c, hidden)
        n = BATCH * side * side
        least = max(W.times((n * act + weights, n * tensor, n * f32))) * 1e3
        phase('kernel', name='lsk_mlp', shape=str(tuple(x.shape)),
              hidden=hidden, launches_per_forward=depth,
              ms=f'{route_ms:.4f}', eager_ms=f'{eager_ms:.4f}',
              fc1_ms=f'{fc1_ms:.4f}', fc2_ms=f'{fc2_ms:.4f}',
              bound_ms=f'{least:.4f}', bound_share=f'{least / route_ms:.3f}',
              kernel_err=f'{errs[0]:.5f}', eager_err=f'{errs[1]:.5f}')
        check(errs[0] <= 1.25 * errs[1],
              'the MLP route errs more than 1.25 times the eager route')
        whole['ms'] += depth * route_ms
        whole['eager_ms'] += depth * eager_ms
        whole['fc1_ms'] += depth * fc1_ms
        whole['fc2_ms'] += depth * fc2_ms
        whole['bound_ms'] += depth * least
        del x, xh, block, p
        torch.cuda.empty_cache()
    for name, rec in recs.items():
        phase('kernel_sum', name=name, launches=LSK_BLOCKS,
              ms=f'{rec["ms"]:.4f}', plain_ms=f'{rec["plain_ms"]:.4f}',
              bound_ms=f'{rec["bound_ms"]:.4f}',
              bound_share=f'{rec["bound_ms"] / rec["ms"]:.3f}')
    phase('kernel_sum', name='lsk_mlp', launches=LSK_BLOCKS,
          ms=f'{whole["ms"]:.4f}', eager_ms=f'{whole["eager_ms"]:.4f}',
          fc1_ms=f'{whole["fc1_ms"]:.4f}', fc2_ms=f'{whole["fc2_ms"]:.4f}',
          bound_ms=f'{whole["bound_ms"]:.4f}',
          bound_share=f'{whole["bound_ms"] / whole["ms"]:.3f}')
    return recs

def lsk_forward(dev, card):
    """[lsk]: a bf16 LSKNet-S backbone (published widths, weights from a
    numpy seed) on a batch of 8 1024^2 images, the launch counts set to 0
    just before it: each attention and MLP kernel launches once a block
    (10) and no other kernel of the port runs. Its four outputs against
    the same module run in float32 (the plain route): the kernels' route errs
    within 1.25 times the eager bf16 route at each. The backbone's ms on
    both routes (CUDA events). Returns the launch counts."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.lsknet import LSKNet
    from r3det_tpu_torch.ops.route import kernels
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    net = LSKNet(dtype=torch.bfloat16)
    net.load_state_dict(seeded_state_dict(net, SEED))
    net = net.to(dev, memory_format=torch.channels_last)
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.uniform(-2, 2, (BATCH, SIZE, SIZE, 3))
                              .astype(np.float32)).to(dev)
    with torch.no_grad():
        net(images)                                   # warm-up
        torch.cuda.synchronize()
        _ext.reset_launches()
        route = net(images)
        torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        route_ms = cuda_ms(lambda: net(images), 5)
        with kernels(False):
            eager = net(images)
            eager_ms = cuda_ms(lambda: net(images), 5)
            net.dtype = torch.float32
            want = net(images)
    phase('launches', path='lsk', **launches)
    for name in PATH_KERNELS['lsk']:
        check(launches[name] == LSK_BLOCKS,
              f'{name} launched {launches[name]} times an LSKNet-S forward, '
              f'not {LSK_BLOCKS}')
    check(all(n == 0 for k, n in launches.items()
              if k not in PATH_KERNELS['lsk']),
          'a kernel other than the attention and MLP kernels ran in '
          'LSKNet-S')
    errs = [(_rel_l2(r, w), _rel_l2(e, w))
            for r, e, w in zip(route, eager, want)]
    phase('lsk', batch=BATCH, size=SIZE, backbone_ms=f'{route_ms:.3f}',
          eager_backbone_ms=f'{eager_ms:.3f}',
          kernel_err=[f'{k:.5f}' for k, _ in errs],
          eager_err=[f'{e:.5f}' for _, e in errs], card=card)
    check(all(k <= 1.25 * e for k, e in errs),
          'the kernels\' route errs more than 1.25 times the eager route')
    del net, images, route, eager, want
    torch.cuda.empty_cache()
    return launches


def _rel_l2(a, b):
    """|a - b| over b's spread, in L2 (the benchmark's ``err.*``)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / (b - b.mean()).norm())


def swin_forward(dev, card):
    """[swin]: a bf16 Swin-T backbone (published widths, weights from a
    numpy seed) on a batch of 8 1024^2 images, the launch counts set to 0
    just before it: each attention kernel launches once a block (12) and
    no other kernel of the port runs. Its three outputs against the same
    module run in float32 (the plain route): the kernels' route errs no
    more than the eager bf16 route at each. Returns the launch counts."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.swin import SwinTransformer
    from r3det_tpu_torch.ops.route import kernels
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    net = SwinTransformer(dtype=torch.bfloat16)
    net.load_state_dict(seeded_state_dict(net, SEED))
    net = net.to(dev)
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.uniform(-2, 2, (BATCH, SIZE, SIZE, 3))
                              .astype(np.float32)).to(dev)
    with torch.no_grad():
        net(images)                                   # warm-up
        torch.cuda.synchronize()
        _ext.reset_launches()
        route = net(images)
        torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        with kernels(False):
            eager = net(images)
            net.dtype = torch.float32
            want = net(images)
    phase('launches', path='swin', **launches)
    for name in PATH_KERNELS['swin']:
        check(launches[name] == SWIN_BLOCKS,
              f'{name} launched {launches[name]} times a Swin-T forward, '
              f'not {SWIN_BLOCKS}')
    check(all(n == 0 for k, n in launches.items()
              if k not in PATH_KERNELS['swin']),
          'a kernel other than the attention kernels ran in Swin-T')
    errs = [(_rel_l2(r, w), _rel_l2(e, w))
            for r, e, w in zip(route, eager, want)]
    phase('swin', batch=BATCH, size=SIZE,
          kernel_err=[f'{k:.5f}' for k, _ in errs],
          eager_err=[f'{e:.5f}' for _, e in errs], card=card)
    check(all(k <= e for k, e in errs),
          'the kernels\' route errs more than the eager bf16 route')
    del net, images, route, eager, want
    torch.cuda.empty_cache()
    return launches


def unfused_block(f, quantize, amax, dev, rng):
    """The identity block K5 replaces, unfused, with numpy-seeded weights:
    bf16 ``Bottleneck.forward`` (cuDNN bf16 convs, FrozenBN, ReLU, the
    residual add), or with ``quantize='static'`` the int8 serving path's
    ``Bottleneck.q8_fused_forward`` (three int8 conv launches), calibrated
    to ``amax``. Returns the call on an NHWC bf16 input."""
    import numpy as np
    import torch

    from r3det_tpu_torch.models.resnet import Bottleneck

    m = Bottleneck(4 * f, f, quantize=quantize).eval()
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith('weight'):
                v = rng.normal(0, t[0].numel() ** -0.5, t.shape)
            elif name.endswith(('var', 'scale')):
                v = rng.uniform(0.5, 1.5, t.shape)
            else:
                v = rng.normal(0, 0.1, t.shape)
            t.copy_(torch.from_numpy(np.asarray(v, np.float32)))
        if quantize:
            for c, a in zip((m.conv1, m.conv2, m.conv3), amax):
                c.act_absmax.copy_(a)
    m = m.to(dev)
    fn = m.q8_fused_forward if quantize else m.forward

    def call(x):
        with torch.no_grad():
            return fn(x.permute(0, 3, 1, 2))
    return call


def compare_bottlenecks(dev, rng):
    """K5 and K5 int8 at R50's identity blocks (C2, C3, C4): each row's ms
    is the sum of one call at each shape, on weights packed once
    (``pack_bottleneck``, timed on its own as ``pack_ms``); ``unfused_ms``
    is the block it replaces, unfused, at the same shape."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.ops import bottleneck_fuse as K5

    rec = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, unfused_ms=0.0,
                   pack_ms=0.0) for k in ('bottleneck', 'bottleneck_q8')}
    for stage, shape, f in BOTTLENECKS:
        c4 = 4 * f
        x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
            dev, torch.bfloat16)
        ws = [torch.from_numpy(rng.normal(0, std, s).astype(np.float32))
              .to(dev) for s, std in (
                  ((1, 1, c4, f), c4 ** -0.5), ((f,), 0.1),
                  ((3, 3, f, f), (9 * f) ** -0.5), ((f,), 0.1),
                  ((1, 1, f, c4), f ** -0.5), ((c4,), 0.1))]
        # static ranges of the three conv inputs (x; a1 and a2 are ReLU
        # outputs of unit-scale convs)
        amax = [x.float().abs().amax(), torch.tensor(4.0, device=dev),
                torch.tensor(3.0, device=dev)]
        # bf16 within the JAX package's bound; int8 bit-equal
        for name, plain, extra, tol in (
                ('bottleneck', K5.fused_bottleneck_reference, [],
                 (0.05, 1e-2)),
                ('bottleneck_q8', K5.fused_bottleneck_q8_reference, amax,
                 (0.0, 0.0))):
            pack = K5.pack_bottleneck(*ws, *extra)
            before = _ext.LAUNCHES[name]
            got = K5.fused_bottleneck_packed(x, pack).float()
            torch.cuda.synchronize()
            check(_ext.LAUNCHES[name] == before + 1,
                  f'{name}: one launch a call')
            want = plain(x, *ws, *extra).float()
            diff = (got - want).abs()
            err = float(diff.max())
            exact = float((diff == 0).float().mean())
            check(bool((diff <= tol[0] + tol[1] * want.abs()).all()),
                  f'{name} at {stage} disagrees with its plain version')
            if name == 'bottleneck':
                check(exact >= 0.98, f'{name} at {stage}: exact share '
                                     f'{exact} below 0.98')
            del got, want, diff
            ms = cuda_ms(lambda: K5.fused_bottleneck_packed(x, pack), 20)
            pack_ms = cuda_ms(lambda: K5.pack_bottleneck(*ws, *extra), 3)
            plain_ms = cuda_ms(lambda: plain(x, *ws, *extra), 3)
            block = unfused_block(f, 'static' if extra else False, amax, dev,
                                  rng)
            unfused_ms = cuda_ms(lambda: block(x), 10)
            # x in and the block's output out, the packed weights (2 bytes
            # bf16, 1 byte int8) and the f32 biases and scales; three convs,
            # 17 F^2 multiply-adds a pixel
            px = x.numel() // c4
            nbytes = 2 * x.numel() * 2 + sum(
                t.numel() * t.element_size() for t in pack if t is not None)
            b_ms, by = add_bound(rec[name], nbytes, 2 * px * 17 * f * f,
                                 'int8' if extra else 'bf16')
            phase('kernel', name=name, stage=stage, shape=str(shape), F=f,
                  max_abs_err=err, exact_frac=exact,
                  tol=f'{tol[0]} + {tol[1]}*|ref|', ms=f'{ms:.4f}',
                  pack_ms=f'{pack_ms:.4f}', plain_ms=f'{plain_ms:.4f}',
                  unfused_ms=f'{unfused_ms:.4f}', bound_ms=f'{b_ms:.4f}',
                  bound_by=by)
            r = rec[name]
            r['max_abs_err'] = max(r['max_abs_err'], err)
            for k, v in (('ms', ms), ('plain_ms', plain_ms),
                         ('unfused_ms', unfused_ms), ('pack_ms', pack_ms)):
                r[k] += v
            del pack, block
        del x, ws
    for name, r in rec.items():
        phase('kernel_sum', name=name, stages='C2+C3+C4', ms=f'{r["ms"]:.4f}',
              pack_ms=f'{r["pack_ms"]:.4f}',
              unfused_ms=f'{r["unfused_ms"]:.4f}',
              plain_ms=f'{r["plain_ms"]:.4f}',
              bound_ms=f'{r["bound_ms"]:.4f}')
    torch.cuda.empty_cache()
    return rec


# QConv's int8 conv at its main-path shapes, with the epilogue each takes
# on the int8 serving path: (name, (B, H, W, Ci), Co, kernel, stride, int8
# input, epilogue); a head tower's first conv quantizes the bf16 P3 map,
# its second takes the first's codes. 'C2_conv2_bf16' is the shape and input that PR 2's
# kernel was timed at (bf16 in, quantized on load, bias, bf16 out).
INT8_CONVS = (
    ('C2_conv1', (BATCH, 256, 256, 256), 64, (1, 1), 1, True,
     dict(affine=True, relu=True, out=True)),
    ('C2_conv2', (BATCH, 256, 256, 64), 64, (3, 3), 1, True,
     dict(affine=True, relu=True, out=True)),
    ('C2_conv2_bf16', (BATCH, 256, 256, 64), 64, (3, 3), 1, False,
     dict(bias=True)),
    ('C2_conv3', (BATCH, 256, 256, 64), 256, (1, 1), 1, True,
     dict(affine=True, res='int8', relu=True)),
    ('C3_conv2_s2', (BATCH, 256, 256, 128), 128, (3, 3), 2, True,
     dict(affine=True, relu=True, out=True)),
    ('C3_downsample', (BATCH, 256, 256, 256), 512, (1, 1), 2, True,
     dict(affine=True)),
    ('C5_conv2', (BATCH, 32, 32, 512), 512, (3, 3), 1, True,
     dict(affine=True, relu=True, out=True)),
    ('head_P3', (BATCH, 128, 128, 256), 256, (3, 3), 1, False,
     dict(bias=True, relu=True, out=True)),
    ('head_P3_conv1', (BATCH, 128, 128, 256), 256, (3, 3), 1, True,
     dict(bias=True, relu=True)),
    ('frm_1x5_P3', (BATCH, 128, 128, 256), 256, (1, 5), 1, False,
     dict(bias=True)),
)


def int8_conv_route(dev, rng):
    """QConv's int8 conv kernel with its fused epilogue against its plain
    version (int8 im2col + torch._int_mm and the unfused PyTorch ops,
    exact) and a bf16 cuDNN conv of the same shape, at each of INT8_CONVS.
    The row's ms, plain_ms and bound_ms sum the shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from r3det_tpu_torch.ops import int8_conv as Q
    rec = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for name, (b, h, w, ci), co, (kh, kw), st, int8_in, spec in INT8_CONVS:
        x = torch.from_numpy(rng.normal(0, 1, (b, h, w, ci))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        ascale = x.float().abs().amax() / 127.0
        if int8_in:
            x = Q.quantize_act(x, ascale)
        wf = torch.from_numpy(rng.normal(0, (kh * kw * ci) ** -0.5,
                                         (kh, kw, ci, co))
                              .astype(np.float32)).to(dev)
        wi, ks = Q.quantize_weights(wf, axes=(0, 1, 2))
        ks = ks.reshape(-1)
        packed = Q.pack_weights(wi)
        bias = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32)).to(
            dev) if spec.get('bias') else None
        pad = (kh // 2, kw // 2)
        ho = (h + 2 * pad[0] - kh) // st + 1
        wo = (w + 2 * pad[1] - kw) // st + 1
        kw_ = dict(relu=spec.get('relu', False))
        res_bytes = 0
        if spec.get('affine'):
            kw_['affine'] = tuple(
                torch.from_numpy(rng.uniform(lo, hi, co).astype(np.float32))
                .to(dev, torch.bfloat16) for lo, hi in ((0.5, 2), (-1, 1)))
        if spec.get('res'):
            r = torch.from_numpy(rng.normal(0, 1, (b, ho, wo, co)).astype(
                np.float32)).to(dev, torch.bfloat16)
            rs = r.float().abs().amax() / 127.0
            kw_['residual'] = (Q.quantize_act(r, rs), rs)
            res_bytes = r.numel()
            del r
        if spec.get('out'):
            kw_['out_scale'] = torch.tensor(4.0 / 127.0, device=dev)
        args = (x, ascale, wi, ks, bias, (st, st), pad)

        def kernel():
            return Q.qconv_fused(*args, packed=packed, **kw_)

        def plain():
            return Q.qconv_fused_reference(*args, **kw_)
        got, want = kernel(), plain()
        if spec.get('out'):
            got, want = got[0], want[0]
        equal = got.shape == want.shape and torch.equal(got, want)
        err = float((got.float() - want.float()).abs().max())
        ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, 3)
        xb = (x.float() * ascale if int8_in else x).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        wb = wf.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=st, padding=pad),
                           10)
        # the input pixels the conv reads, the weights, the residual and
        # the output, each once
        rows = len({oy * st - pad[0] + ky for oy in range(ho)
                    for ky in range(kh)} & set(range(h)))
        cols = len({ox * st - pad[1] + kx for ox in range(wo)
                    for kx in range(kw)} & set(range(w)))
        nbytes = (b * rows * cols * ci * x.element_size() + wi.numel()
                  + res_bytes + got.numel() * got.element_size())
        b_ms, by = add_bound(rec, nbytes, 2 * b * ho * wo * co * kh * kw * ci,
                             'int8')
        phase('kernel', name='int8_conv', stage=name,
              shape=f'({b},{h},{w},{ci})->{co} {kh}x{kw}/s{st}',
              input='int8' if int8_in else 'bf16',
              epilogue='+'.join(k for k, v in spec.items() if v) or 'none',
              out=str(got.dtype).replace('torch.', ''), bit_equal=equal,
              max_abs_err=err, tol=0.0, ms=f'{ms:.4f}',
              plain_ms=f'{plain_ms:.4f}', bound_ms=f'{b_ms:.4f}',
              bound_by=by, cudnn_bf16_ms=f'{cudnn_ms:.4f}')
        check(equal, f'int8_conv disagrees with its plain version ({name})')
        rec['max_abs_err'] = max(rec['max_abs_err'], err)
        rec['ms'] += ms
        rec['plain_ms'] += plain_ms
        del x, got, want, xb, args, kw_
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _sr_logits(model, images):
    """Refine-head cls logits, all levels: (B, N, C) f32."""
    import torch
    with torch.no_grad():
        out = model(images)
    cls = out['sr'][-1][0]
    c = model.cfg.num_classes
    return torch.cat([t.reshape(t.shape[0], -1, c) for t in cls], 1)


def calibrate_cls(model, images, featmap_sizes):
    """Set the refine head's final cls layer from the seeded forward pass:
    weights rescaled so its logits spread with unit std, and one bias per
    target so each batch reaches its live-candidate count (LIVE_TARGETS,
    and STREAM_LIVE for the streamed sweep's run). Returns {branch:
    bias}."""
    import torch
    head = model.refine_head_0.retina_cls
    base = float(head.bias.detach()[0])
    logits = _sr_logits(model, images) - base
    with torch.no_grad():
        head.weight.mul_(1.0 / float(logits.std()))
    logits = _sr_logits(model, images) - base
    # the candidates NMS sees: per level the top nms_pre positions
    nms_pre = model.cfg.test.nms_pre
    kept, start = [], 0
    for h, w in featmap_sizes:
        lvl = logits[:, start:start + h * w]
        start += h * w
        k = min(nms_pre, h * w)
        idx = torch.sort(lvl.amax(-1), dim=1, descending=True,
                         stable=True).indices[:, :k]
        kept.append(lvl.gather(1, idx[..., None].expand(-1, -1, lvl.shape[-1])))
    flat = torch.sort(torch.cat(kept, 1).reshape(logits.shape[0], -1), dim=1,
                      descending=True).values
    thr = math.log(model.cfg.test.score_thr / (1 - model.cfg.test.score_thr))
    biases = {}
    for branch, target in dict(LIVE_TARGETS, stream=STREAM_LIVE).items():
        # the image with the most live candidates decides the branch
        biases[branch] = thr - float(flat[:, target].max()) \
            if branch == 'small' else thr - float(flat[:, target].min())
    return biases


def _set_bias(model, value):
    import torch
    with torch.no_grad():
        model.refine_head_0.retina_cls.bias.fill_(value)


def _agreement(a, b):
    """Fraction of detections of run a found in run b (same label, box and
    score within 1e-2 relative), over the batch."""
    import torch
    (da, la, na), (db, lb, nb) = a, b
    found = total = 0
    for i in range(da.shape[0]):
        xa, xb = da[i, :int(na[i])], db[i, :int(nb[i])]
        if len(xa) == 0:
            continue
        same = (la[i, :int(na[i])][:, None] == lb[i, :int(nb[i])][None]) & \
            ((xa[:, None] - xb[None]).abs()
             <= 1e-2 * (xa[:, None].abs() + 1)).all(-1)
        found += int(same.any(1).sum())
        total += len(xa)
    return found / max(total, 1)


def stage_times(model, images, sizes, iters=5):
    """Mean ms per batch of each stage of the R3Det forward and predict
    (CUDA events)."""
    import torch

    from r3det_tpu_torch.models.detectors import (detector_predict,
                                                  filter_bboxes,
                                                  level_anchors)
    cfg = model.cfg
    names = ('backbone', 'neck', 'bbox_head', 'filter_bboxes', 'frm',
             'refine_head', 'predict')
    tot = [0.0] * len(names)
    with torch.no_grad():
        for it in range(iters + 1):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(names) + 1)]
            ev[0].record()
            feats = model.backbone(images)
            ev[1].record()
            feats = model.neck(feats)
            ev[2].record()
            cls0, reg0 = model.bbox_head(feats)
            ev[3].record()
            anchors = level_anchors(cfg, [tuple(c.shape[1:3]) for c in cls0],
                                    images.device)
            rois = filter_bboxes(cls0, reg0, anchors, cfg.coder(), cfg)
            ev[4].record()
            feats = model.frm_0(feats, rois)
            ev[5].record()
            cls, reg = model.refine_head_0(feats)
            ev[6].record()
            detector_predict({'s0': (cls0, reg0), 'sr': [(cls, reg)],
                              'rois': [rois]}, cfg, sizes,
                             img_shape=(SIZE, SIZE), kernels=model.kernels)
            ev[7].record()
            torch.cuda.synchronize()
            if it == 0:                                   # warm-up
                continue
            spans = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7)]
            for i, (a, b) in enumerate(spans):
                tot[i] += ev[a].elapsed_time(ev[b])
    return {n: tot[i] / iters for i, n in enumerate(names)}


def end_to_end(dev, card):
    """Phase 4, bf16. Returns the run's launch counts and what the int8
    path and the routes reuse."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.detectors import (R3DET_R50_V1, TestCfg,
                                                  build_detector,
                                                  detector_predict,
                                                  use_kernels)
    from r3det_tpu_torch.parallel.predict import make_predict_step
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    cfg = R3DET_R50_V1._replace(
        stacked_convs=2, test=TestCfg(approx_topk=False, nms_candidates=None))
    model = build_detector(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.uniform(-2, 2, (BATCH, SIZE, SIZE, 3))
                              .astype(np.float32)).to(dev)
    sizes = tuple((SIZE // s, SIZE // s) for s in cfg.strides)
    step = make_predict_step(model, cfg, sizes, img_shape=(SIZE, SIZE))
    biases = calibrate_cls(model, images, sizes)

    def run(branch):
        _set_bias(model, biases[branch])
        return _with_branch(lambda: step(images))

    # the main-path run: counts from zero, both NMS branches
    torch.cuda.synchronize()
    _ext.reset_launches()
    results = {br: run(br) for br in LIVE_TARGETS}
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='bf16', **launches)
    for name in PATH_KERNELS['bf16']:
        check(launches[name] > 0,
              f'kernel {name} was not launched on the bf16 path')
    check(launches['stem_conv_pool'] == len(LIVE_TARGETS),
          'the stem kernel did not run once a predict step (bf16)')
    check(launches['frm_sample'] == len(LIVE_TARGETS) * cfg.num_refine_stages,
          'K2 did not run once a refine stage a predict step (bf16)')
    check(launches['conv_epilogue'] == len(LIVE_TARGETS) * R50_EPILOGUES,
          'the conv epilogue did not run once a bottleneck conv (bf16)')
    check(all(launches[name] == 0 for name in PATH_KERNELS['swin']),
          'a Swin kernel ran in the R50 predict step')

    for branch, (dets, labels, num, taken) in results.items():
        phase('predict', batch=branch, branch=taken, num=num.tolist())
        check(taken == branch, f'expected the {branch} NMS branch, '
                               f'took {taken}')
        check(tuple(dets.shape) == (BATCH, cfg.test.max_per_img, 6)
              and tuple(labels.shape) == (BATCH, cfg.test.max_per_img)
              and tuple(num.shape) == (BATCH,), 'wrong output shapes')
        check(bool(torch.isfinite(dets).all()), 'non-finite detections')
        check(bool((num > 0).all()), 'an image has no detection')

    # NMS alone: the same head outputs through K1 and through the plain IoU
    # must keep the same boxes
    for branch in LIVE_TARGETS:
        _set_bias(model, biases[branch])
        with torch.no_grad():
            out = model(images)
        k, seen = nms_iou_inputs(lambda: detector_predict(
            out, cfg, sizes, img_shape=(SIZE, SIZE)))
        p = detector_predict(out, cfg, sizes, img_shape=(SIZE, SIZE),
                             kernels=False)
        same = all(torch.equal(u, v) for u, v in zip(k, p))
        phase('nms_parity', batch=branch, identical=same)
        check(same, f'NMS with K1 differs from the plain IoU ({branch})')
        if branch == 'big':
            check(len(seen) == 1, f'NMS called K1 {len(seen)} times')
            iou_main_path(*seen[0], card)
        del out, k, p, seen

    # speed, then the plain versions on the card
    def rate(branch, iters=5):
        _set_bias(model, biases[branch])
        step(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(images)
        torch.cuda.synchronize()
        return BATCH * iters / (time.perf_counter() - t0)

    speed = {br: rate(br) for br in LIVE_TARGETS}
    kernel_logits = _sr_logits(model, images)
    use_kernels(model, False)
    plain = {br: run(br) for br in LIVE_TARGETS}
    plain_speed = {br: rate(br) for br in LIVE_TARGETS}
    plain_logits = _sr_logits(model, images)
    use_kernels(model, True)
    # the stem kernel's f32 sums round a few bf16 outputs the other way
    # (phase 3); through 50 bf16 layers that moves the logits slightly, and
    # NMS on bf16-tied scores amplifies it, so detections agree closely
    # but not exactly
    rel = float((kernel_logits - plain_logits).abs().max()
                / plain_logits.abs().max())
    phase('forward_parity', sr_logits_max_rel_diff=f'{rel:.5f}', tol=0.05)
    check(rel <= 0.05, 'the forward pass with kernels drifts from plain')
    for branch in LIVE_TARGETS:
        kd, pd = results[branch][:3], plain[branch][:3]
        found, back = _agreement(kd, pd), _agreement(pd, kd)
        phase('e2e', batch=branch, patches_per_s=f'{speed[branch]:.2f}',
              plain_patches_per_s=f'{plain_speed[branch]:.2f}',
              dets_found_in_plain=f'{found:.4f}',
              plain_found_in_kernel=f'{back:.4f}', tol=0.75,
              num=kd[2].tolist(), plain_num=pd[2].tolist(), card=card)
        check(min(found, back) >= 0.75,
              f'kernel and plain detections disagree ({branch})')
    _set_bias(model, biases['big'])
    phase('stages', path='bf16', batch='big', card=card,
          **{k: f'{v:.3f}' for k, v in stage_times(model, images,
                                                   sizes).items()})
    profile_step(step, images, 'bf16', card)
    return dict(launches=launches, model=model, images=images, sizes=sizes,
                biases=biases, cfg=cfg, step=step)


def _with_branch(fn):
    """``fn()``'s result with the NMS budget's branch appended, read from
    the ``r3det.nms.sweep.*`` span of a CPU profile with the port's spans
    on."""
    from torch.profiler import ProfilerActivity, profile

    from r3det_tpu_torch.utils import tracing
    tracing.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        tracing.enable(False)
    branches = [e.name.rsplit('.', 1)[1] for e in prof.events()
                if e.name.startswith('r3det.nms.sweep.')]
    check(len(branches) == 1, f'{len(branches)} NMS sweeps in one step')
    return tuple(out) + (branches[0],)


def _spy(module, name, calls):
    """Replace ``module.name`` by a wrapper recording each call's (args,
    kwargs) in ``calls``; returns the function that undoes it."""
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    setattr(module, name, spy)
    return lambda: setattr(module, name, real)


def iou_slab(b1, b2, vc, card):
    """K1 alone on one streamed-sweep slab of a main-path run (all the
    sorted candidates against one block, ``valid_count``), against its
    plain version (bit-equal), timed, with its near pairs."""
    import torch

    from r3det_tpu_torch.ops import rotated_iou as K1
    got = K1.rotated_iou_cuda(b1, b2, valid_count=vc)
    want = K1.rotated_iou_reference(b1, b2, valid_count=vc)
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: K1.rotated_iou_cuda(b1, b2, valid_count=vc), 20)
    plain_ms = cuda_ms(
        lambda: K1.rotated_iou_reference(b1, b2, valid_count=vc), 3)
    work = iou_work(b1, vc, got, boxes2=b2)
    phase('kernel', name='rotated_iou',
          shape=f'({b1.shape[0]},{b1.shape[1]},{b2.shape[1]})',
          candidates=STREAM_CANDIDATES, valid_count=vc.tolist(),
          max_abs_err=err, tol=0.0, ms=f'{ms:.4f}',
          plain_ms=f'{plain_ms:.4f}', card=card,
          **{n: f'{v:.4f}' if isinstance(v, float) else v
             for n, v in work.items()})
    check(err == 0.0 and torch.equal(got, want),
          'rotated_iou disagrees with its plain version on a streamed slab')


def nms_stream(dev, card, base):
    """Phase 4, the streamed sweep: the bf16 path's model at batch 8 with
    ``nms_candidates=STREAM_CANDIDATES`` and the refine cls bias set for
    STREAM_LIVE live candidates an image. The big branch must run and
    stream (K1 once a block of 512 sorted candidates in the predict
    step); NMS with K1 keeps what the plain IoU keeps; the streamed sweep
    called alone on the first STREAM_CUT sorted candidates keeps what the
    dense sweep keeps. Prints ms a step, patches/s, the peak memory beside
    the dense (B, K, K) f32 matrix it replaces (computed, not allocated),
    and K1 alone on the costliest slab. Returns the run's launch counts."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.detectors import detector_predict
    from r3det_tpu_torch.ops import nms
    from r3det_tpu_torch.parallel.predict import make_predict_step

    model, images, sizes = base['model'], base['images'], base['sizes']
    cfg = base['cfg']._replace(test=base['cfg'].test._replace(
        nms_candidates=STREAM_CANDIDATES))
    small_k = max(cfg.test.max_per_img, cfg.test.nms_pre)
    blocks = -(-STREAM_CANDIDATES // nms.STREAM_BLOCK)
    step = make_predict_step(model, cfg, sizes, img_shape=(SIZE, SIZE))
    _set_bias(model, base['biases']['stream'])
    step(images)                                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _ext.reset_launches()
    result = _with_branch(lambda: step(images))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    phase('launches', path='stream', **launches)
    for name in PATH_KERNELS['stream']:
        check(launches[name] > 0,
              f'kernel {name} was not launched on the streamed path')
    check(launches['rotated_iou'] == blocks,
          f'K1 ran {launches["rotated_iou"]} times in a streamed predict '
          f'step, not once a block ({blocks})')
    check(result[3] == 'big',
          f'the streamed run took the {result[3]} branch, not big (more '
          f'live candidates than {small_k})')
    _check_dets(result, cfg, BATCH, 'stream')
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / len(times)

    # NMS alone on the same head outputs: K1 against the plain IoU; the
    # sweep's sorted candidates and K1's slabs recorded
    with torch.no_grad():
        out = model(images)
    cores, slabs = [], []
    undo = [_spy(nms, 'nms_core_presorted', cores),
            _spy(nms, 'rotated_iou', slabs)]
    try:
        k = detector_predict(out, cfg, sizes, img_shape=(SIZE, SIZE))
    finally:
        for u in undo:
            u()
    p = detector_predict(out, cfg, sizes, img_shape=(SIZE, SIZE),
                         kernels=False)
    same = all(torch.equal(u, v) for u, v in zip(k, p))
    check(len(cores) == 1 and len(slabs) == blocks,
          f'{len(cores)} sweeps, {len(slabs)} K1 calls')
    boxes, valid, labels = (a[:, :STREAM_CUT] for a in cores[0][0][:3])
    ar = torch.arange(STREAM_CUT, device=dev)
    vcount = torch.where(valid, ar + 1, torch.zeros_like(ar)).amax(1)
    thr = cfg.test.nms_iou_thr
    keep_s = nms.greedy_keep_streamed(boxes, valid, labels, thr, vcount)
    keep_d = nms.greedy_keep_dense(boxes, valid, labels, thr, vcount)
    cut_same = torch.equal(keep_s, keep_d)
    phase('nms_stream', config='R3DET_R50_V1 stacked_convs=2',
          batch=BATCH, nms_candidates=STREAM_CANDIDATES,
          live=int(cores[0][0][1].sum(1).max()), branch=result[3],
          k1_launches=launches['rotated_iou'], blocks=blocks,
          num=result[2].tolist(), identical_to_plain=same,
          cut=STREAM_CUT, cut_kept=keep_s.sum(1).tolist(),
          streamed_equals_dense=cut_same, ms_per_step=f'{ms:.3f}',
          patches_per_s=f'{BATCH * 1e3 / ms:.2f}',
          max_memory_allocated_gb=f'{peak / 2 ** 30:.3f}',
          dense_iou_gb=f'{BATCH * STREAM_CANDIDATES ** 2 * 4 / 2 ** 30:.3f}',
          card=card)
    check(same, 'the streamed NMS with K1 differs from the plain IoU')
    check(cut_same, 'the streamed sweep differs from the dense sweep')
    # K1 alone on the slab with the most live rows
    i = max(range(len(slabs)),
            key=lambda j: int(slabs[j][1]['valid_count'].sum()))
    (b1, b2), kw = slabs[i]
    iou_slab(b1, b2, kw['valid_count'], card)
    del out, k, p, cores, slabs, b1, b2
    torch.cuda.empty_cache()
    return launches


def _plain_forward(module):
    """Make ``module``'s forward run with the kernels switched off."""
    from r3det_tpu_torch.ops.route import kernels
    forward = module.forward

    def plain(*args, **kwargs):
        with kernels(False):
            return forward(*args, **kwargs)
    module.forward = plain


def _flat(x):
    """The tensors of a nested tuple, in order."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _flat(y)]
    return [x]


def nms_family(dev, card):
    """Phase 4, the single-image NMS family and the IoU calculators on
    seeded scenes of NMS_FAMILY_K boxes on the card: each with K1 against
    its plain route (under ``kernels(False)``), which must keep the same
    boxes,
    and rbbox_overlaps_v1/v2/v3 equal to their plain forms. poly_nms
    (plain torch ops) runs and reports its count. Returns the kernel
    route's launch counts."""
    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.core import iou_calculators as IC
    from r3det_tpu_torch.ops import nms
    from r3det_tpu_torch.ops.rotated_iou import rbbox_overlaps
    from r3det_tpu_torch.ops.route import kernels
    from r3det_tpu_torch.core.rtransforms import obb2poly

    rng = np.random.RandomState(SEED)
    k = NMS_FAMILY_K
    centres = rng.uniform(0, SIZE, (k // 4, 2)).repeat(4, 0)
    boxes = np.concatenate([centres + rng.uniform(-10, 10, (k, 2)),
                            rng.uniform(8, 80, (k, 2)),
                            rng.uniform(-math.pi / 2, math.pi / 2, (k, 1))],
                           -1)
    small = rng.uniform(size=k) < 0.05
    boxes[small, 2] = 5e-4
    scores = rng.uniform(0.05, 1.0, k)
    labels = rng.randint(0, 15, k)
    n_pos, c = k // 2, 3
    mboxes = boxes[:n_pos]
    mscores = np.concatenate([rng.uniform(0, 1, (n_pos, c)),
                              np.zeros((n_pos, 1))], -1)

    def dev_t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    bx, sc, lb = dev_t(boxes), dev_t(scores), dev_t(labels, torch.long)
    dets = torch.cat([bx, sc[:, None]], 1)
    calls = {
        'rnms': lambda kr: nms.rnms(dets, 0.1),
        'rnms_negate': lambda kr: nms.rnms(dets, 0.1, negate_angle=True),
        **{name: (lambda kr, f=getattr(nms, name): f(bx, sc, lb, 0.1))
           for name in ('batched_rnms', 'ml_nms_rotated', 'obb_batched_nms')},
        **{f'multiclass_{v}': (
            lambda kr, v=v: nms.multiclass_nms_rotated(
                dev_t(mboxes), dev_t(mscores), 0.05, 0.1, version=v,
                pre_topk=k))
           for v in ('v1', 'v2', 'v3', 'mmcv')},
    }
    # the calculators against their policy restated on the plain route
    for v in ('v1', 'v2', 'v3'):
        cls = getattr(IC, f'RBboxOverlaps2D_{v}')
        calls[f'rbbox_overlaps_{v}'] = (
            lambda kr, v=v, cls=cls: getattr(IC, f'rbbox_overlaps_{v}')(
                dets, bx) if kr else rbbox_overlaps(
                    dets, bx, small_box_thr=cls.small_box_thr,
                    negate_angle=cls.negate_angle))
    torch.cuda.synchronize()
    _ext.reset_launches()
    t0 = time.perf_counter()
    got = {name: fn(True) for name, fn in calls.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='nms_family', **launches)
    check(launches['rotated_iou'] == len(got),
          f'K1 ran {launches["rotated_iou"]} times for {len(got)} calls')
    kept, equal = {}, {}
    for name, fn in calls.items():
        with kernels(False):
            plain = fn(False)
        equal[name] = all(torch.equal(a, b) for a, b in
                          zip(_flat(got[name]), _flat(plain)))
        if not name.startswith('rbbox'):
            kept[name] = int(_flat(got[name])[-1])
    poly = nms.poly_nms(torch.cat([obb2poly(bx), sc[:, None]], 1), 0.1)
    phase('nms_family', boxes=k, kept=json.dumps(kept),
          equal_to_plain=json.dumps(equal), poly_nms_kept=int(poly[1]),
          kernel_route_s=f'{seconds:.3f}', card=card)
    check(all(equal.values()), 'an NMS or IoU call with K1 differs from '
                               'its plain route')
    check(all(v > 0 for v in kept.values()) and int(poly[1]) > 0,
          'an NMS call kept nothing')
    return launches


def frm_options(dev, card, base):
    """Phase 4, the FRM build options on the bf16 path's weights at batch
    ROUTE_BATCH: ``frm_fuse_convs`` (the branch as one cuDNN 5x5 conv) runs
    K2 once a forward and equals its FRM's plain route as ``[frm5]``
    requires; its refine logits lie a printed relative distance from the
    unfused model's (a reassociation, another bf16 function); with
    ``frm_sample_kernel='band'`` the model equals the default's bit for
    bit. Returns the fused run's launch counts."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.frm import FeatureRefineModule
    from r3det_tpu_torch.parallel.predict import make_predict_step

    cfg, images, sizes = base['cfg'], base['images'][:ROUTE_BATCH], \
        base['sizes']
    _set_bias(base['model'], base['biases']['big'])
    state = base['model'].state_dict()

    def run(model):
        step = make_predict_step(model, cfg, sizes, img_shape=(SIZE, SIZE))
        return _sr_logits(model, images), step(images)

    fused = _copy_model(cfg, state, dev, frm_fuse_convs=True)
    torch.cuda.synchronize()
    _ext.reset_launches()
    logits, dets = run(fused)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='frm_fused', **launches)
    for name in PATH_KERNELS['frm_fused']:
        check(launches[name] > 0,
              f'kernel {name} was not launched with frm_fuse_convs')
    check(launches['frm_sample'] == 2 * cfg.num_refine_stages,
          f'K2 ran {launches["frm_sample"]} times in two fused forwards')
    _check_dets(dets, cfg, ROUTE_BATCH, 'frm_fused')
    for m in fused.modules():
        if isinstance(m, FeatureRefineModule):
            _plain_forward(m)
    plain_logits, plain_dets = run(fused)
    same = torch.equal(logits, plain_logits) and all(
        torch.equal(a, b) for a, b in zip(dets, plain_dets))
    del fused
    # the same build without the options
    default_logits, default_dets = run(_copy_model(cfg, state, dev))
    rel = _rel(logits, default_logits)
    band = _copy_model(cfg, state, dev, frm_sample_kernel='band')
    band_logits, band_dets = run(band)
    band_same = torch.equal(band_logits, default_logits) and all(
        torch.equal(a, b) for a, b in zip(band_dets, default_dets))
    del band
    torch.cuda.empty_cache()
    phase('frm_options', batch=ROUTE_BATCH,
          fused_frm_launches=launches['frm_sample'],
          fused_equal_to_plain=same,
          fused_sr_logits_rel_to_unfused=f'{rel:.5f}',
          num=dets[2].tolist(), band_equal_to_default=band_same, card=card)
    check(same, 'the fused-conv FRM differs from its plain route')
    check(band_same, "frm_sample_kernel='band' differs from the default")
    return launches


def hbb_train(dev, card):
    """Phase 6, horizontal anchors: one train step of rotated RetinaNet v1
    (R50, ``hbb_anchors``, the rotated assignment on the anchors'
    ``hbb2obb`` boxes, L1 loss), bf16 on f32 parameters, batch TRAIN_BATCH
    of 1024^2, seeded weights and batch, after one warm-up step: finite
    losses, K1 in the assignment, K3 in the frozen stem, ms a step.
    Returns the timed step's launch counts."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.datasets.synthetic import SyntheticDetData
    from r3det_tpu_torch.models.detectors import (DetectorConfig,
                                                  StageTrainCfg, TestCfg,
                                                  build_detector)
    from r3det_tpu_torch.parallel.train import make_train_step
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    cfg = DetectorConfig(angle_version='v1', loss_bbox_type='l1',
                         s0_train=StageTrainCfg(0.5, 0.4, 0.0, None),
                         test=TestCfg(nms_version='v1'), hbb_anchors=True)
    model = build_detector(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    data = SyntheticDetData(batch_size=TRAIN_BATCH, size=SIZE,
                            max_gt=TRAIN_MAX_GT, num_classes=cfg.num_classes,
                            seed=SEED).batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    sizes = tuple((SIZE // s, SIZE // s) for s in cfg.strides)
    step = make_train_step(model, cfg, sizes)
    first = step(batch)
    torch.cuda.synchronize()
    _ext.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = step(batch)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='hbb_train', steps=1, **launches)
    losses = {k: float(v) for k, v in losses.items()}
    phase('hbb_train', config='rotated RetinaNet v1 hbb_anchors',
          batch=TRAIN_BATCH, size=SIZE,
          first=json.dumps({k: float(v) for k, v in first.items()}),
          losses=json.dumps(losses), ms_per_step=f'{ms:.3f}', card=card)
    check(all(math.isfinite(v) for v in losses.values()),
          'a non-finite loss with hbb_anchors')
    for name in PATH_KERNELS['hbb_train']:
        check(launches[name] == 1,
              f'kernel {name} ran {launches[name]} times in one hbb step')
    del model, step, batch
    torch.cuda.empty_cache()
    return launches


def _padded_results(results):
    """Per-image per-class (n, 6) arrays -> (dets (B, N, 6), labels (B, N),
    num (B,)) tensors, the predict step's layout."""
    import torch
    n = max(1, max(sum(len(c) for c in r) for r in results))
    dets = torch.zeros(len(results), n, 6)
    labels = torch.full((len(results), n), -1, dtype=torch.long)
    num = torch.zeros(len(results), dtype=torch.long)
    for i, r in enumerate(results):
        k = sum(len(c) for c in r)
        dets[i, :k] = torch.cat([torch.from_numpy(c) for c in r])
        labels[i, :k] = torch.cat([torch.full((len(c),), c_id)
                                   for c_id, c in enumerate(r)])
        num[i] = k
    return dets, labels, num


def _same_results(a, b):
    import numpy as np
    return all(np.array_equal(x, y) for ra, rb in zip(a, b)
               for x, y in zip(ra, rb))


def _ap_line(metrics):
    return json.dumps({k: round(v, 6) for k, v in metrics.items()})


def _spread(xs, fmt='.4f'):
    """'median [min, max]' of a list of numbers."""
    import statistics
    return (f'{statistics.median(xs):{fmt}} '
            f'[{min(xs):{fmt}}, {max(xs):{fmt}}]')


def _decode_split(ds, repeats):
    """Seconds, per pass over every image of ``ds`` (``repeats`` passes),
    of each part of ``image_io.imread``: the file read, zlib's inflate,
    the C++ unfilter, and the rest of ``decode_png`` (chunk parsing,
    samples to BGR); the rest is the whole ``decode_png`` less inflate
    and unfilter, each timed alone on the same bytes."""
    import struct
    import zlib

    from r3det_tpu_torch.datasets import image_io
    paths = [os.path.join(ds.img_folder, info['filename'])
             for info in ds.data_infos]
    runs = {k: [] for k in ('read', 'inflate', 'unfilter', 'rest')}
    for _ in range(repeats):
        t = dict.fromkeys(runs, 0.0)
        for path in paths:
            t0 = time.perf_counter()
            with open(path, 'rb') as f:
                data = f.read()
            t1 = time.perf_counter()
            chunks = list(image_io._chunks(data))
            w, h, depth, ctype = struct.unpack(
                '>IIBB', dict(chunks)[b'IHDR'][:10])
            ch = image_io._CHANNELS[ctype]
            idat = b''.join(b for k, b in chunks if k == b'IDAT')
            t2 = time.perf_counter()
            raw = zlib.decompress(idat)
            t3 = time.perf_counter()
            image_io.unfilter(raw, h, (w * ch * depth + 7) // 8,
                              max(1, ch * depth // 8))
            t4 = time.perf_counter()
            image_io.decode_png(data)
            t5 = time.perf_counter()
            t['read'] += t1 - t0
            t['inflate'] += t3 - t2
            t['unfilter'] += t4 - t3
            t['rest'] += (t5 - t4) - (t4 - t2)
        for k in runs:
            runs[k].append(t[k])
    return runs


def eval_path(dev, card):
    """The DOTA evaluation path ([eval]); returns the launch counts of the
    bf16 kernel route's run."""
    import shutil

    import numpy as np
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.datasets.dota import DOTADataset
    from r3det_tpu_torch.models.detectors import use_kernels
    from r3det_tpu_torch.models.quant import calibrate
    from r3det_tpu_torch.tools import make_fake_dota
    from r3det_tpu_torch.tools.test import (calibration_batches,
                                            pipeline_image_size)
    from r3det_tpu_torch.utils.builder import build_from_config
    from r3det_tpu_torch.utils.config import Config
    from r3det_tpu_torch.utils.convert import seeded_state_dict
    from r3det_tpu_torch.utils.eval_loop import (evaluate_dataset,
                                                 test_pipeline,
                                                 transform_batch)

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, 'build', 'eval_smoke')
    shutil.rmtree(work, ignore_errors=True)
    raw, split = os.path.join(work, 'raw'), os.path.join(work, 'split')
    t0 = time.perf_counter()
    make_fake_dota.main(['--out', raw, '--split-out', split,
                         '--num-images', str(EVAL_IMAGES)])
    make_s = time.perf_counter() - t0
    cfg = Config.fromfile(os.path.join(root, EVAL_CONFIG))
    cfg.merge_from_options({'data.test.ann_file': split + '/annfiles/',
                            'data.test.img_prefix': split + '/images/'})
    test_d = cfg.data.test
    model, det_cfg = build_from_config(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    ds = DOTADataset(test_d.ann_file, test_d.img_prefix,
                     version=det_cfg.angle_version, filter_empty=False,
                     classes=test_d.classes)
    scenes = DOTADataset(raw + '/labelTxt/', raw + '/images/',
                         version=det_cfg.angle_version, filter_empty=False,
                         classes=test_d.classes)
    hw = pipeline_image_size(test_d)
    batches = -(-len(ds) // EVAL_BATCH)
    check(hw == (SIZE, SIZE) and batches >= 4 and
          len(ds) == batches * EVAL_BATCH,
          f'{len(ds)} patches at {hw}: not >= 4 full batches at {SIZE}^2')

    # the eval machinery alone: ground truth as detections, merged into the
    # scenes and scored against the scenes' own labels
    def oracle(shift):
        res = []
        for info in ds.data_infos:
            b = info['ann']['bboxes'].copy()
            b[:, 0] += shift
            lbl = info['ann']['labels']
            res.append([np.concatenate(
                [b[lbl == c], np.full(((lbl == c).sum(), 1), 0.9,
                                      np.float32)], -1)
                for c in range(len(ds.CLASSES))])
        ids, merged = ds.merge_det(res)
        order = [ids.index(info['id']) for info in scenes.data_infos]
        return scenes.evaluate([merged[i] for i in order], logger=None)
    exact, shifted = oracle(0.0), oracle(float(EVAL_SHIFT))
    phase('eval_oracle', scenes=len(scenes), patches=len(ds),
          gts=sum(len(i['ann']['labels']) for i in scenes.data_infos),
          mAP=exact['mAP'], shifted_mAP=shifted['mAP'], shift=EVAL_SHIFT)
    check(exact['mAP'] == 1.0, 'ground truth as detections scores '
                               f'mAP {exact["mAP"]}, not 1.0')
    check(shifted['mAP'] < 0.1, 'ground truth shifted off itself scores '
                                f'mAP {shifted["mAP"]}')

    # the transforms on the card against the CPU, one decoded patch
    sample = ds.get_sample(0)
    outs = [transform_batch([dict(sample)], test_pipeline(hw)[0], where)[0]
            .cpu() for where in ('cpu', dev)]
    same_tf = torch.equal(outs[0], outs[1])
    phase('eval_transforms', input=str(tuple(sample['img'].shape)),
          output=str(tuple(outs[1].shape)), bit_equal=same_tf)
    check(same_tf, 'RResize/Normalize/Pad on the card differ from the CPU')

    # the refine cls layer from the seeded pass on the first batch, so that
    # every patch sends detections through merge and mAP
    first = calibration_batches(ds, 1, EVAL_BATCH, hw, dev)[0]
    sizes = tuple((SIZE // s, SIZE // s) for s in det_cfg.strides)
    _set_bias(model, calibrate_cls(model, first, sizes)['small'])

    def run(m, mcfg=det_cfg, times=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = evaluate_dataset(m, mcfg, ds, img_size=hw,
                               batch_size=EVAL_BATCH, times=times)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    torch.cuda.synchronize()
    _ext.reset_launches()
    results, first_s = run(model)
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='eval', batches=batches, **launches)
    for name in PATH_KERNELS['bf16']:
        per_step = R50_EPILOGUES if name == 'conv_epilogue' else 1
        check(launches[name] == per_step * batches,
              f'kernel {name} ran {launches[name]} times in {batches} '
              f'predict steps of the eval path, not {per_step} a step')
    check(all(sum(len(c) for c in r) > 0 for r in results),
          'a patch has no detection on the eval path')
    # the timed runs: host clocks on a shared host vary from run to run,
    # so EVAL_REPEATS runs, each split into its phases
    splits = []
    for _ in range(EVAL_REPEATS):
        splits.append({})
        _, splits[-1]['run'] = run(model, times=splits[-1])
    decode = _decode_split(ds, EVAL_REPEATS)
    t = time.perf_counter()
    ids, merged = ds.merge_det(results)
    merge_s = time.perf_counter() - t
    t = time.perf_counter()
    metrics = ds.evaluate(results, logger=None)
    map_s = time.perf_counter() - t
    use_kernels(model, False)
    plain, plain_s = run(model)
    use_kernels(model, True)
    plain_metrics = ds.evaluate(plain, logger=None)
    kd, pd = _padded_results(results), _padded_results(plain)
    found, back = _agreement(kd, pd), _agreement(pd, kd)
    spread = {k: _spread([sp[k] for sp in splits])
              for k in ('run', 'decode', 'transforms', 'predict')}
    phase('eval', config=EVAL_CONFIG, patches=len(ds), batch=EVAL_BATCH,
          size=SIZE, repeats=EVAL_REPEATS,
          images_per_s=_spread([len(ds) / sp['run'] for sp in splits],
                               '.2f'),
          first_run_s=f'{first_s:.3f}', run_s=spread['run'],
          decode_s=spread['decode'], transforms_s=spread['transforms'],
          predict_s=spread['predict'],
          merge_s=f'{merge_s:.4f}', map_s=f'{map_s:.4f}',
          make_fake_dota_s=f'{make_s:.2f}', merged_scenes=len(ids),
          dets=int(kd[2].sum()), plain_dets=int(pd[2].sum()),
          dets_found_in_plain=f'{found:.4f}',
          plain_found_in_kernel=f'{back:.4f}', tol=0.75,
          plain_run_s=f'{plain_s:.3f}', card=card)
    phase('eval_decode', images=len(ds), repeats=EVAL_REPEATS,
          **{f'{k}_s': _spread(v) for k, v in decode.items()}, card=card)
    phase('eval_ap', kernel=_ap_line(metrics), plain=_ap_line(plain_metrics))
    check(min(found, back) >= 0.75,
          'kernel and plain detections disagree on the eval path')

    # the test CLI's --out pickle, for [vis]
    with open(os.path.join(work, 'results.pkl'), 'wb') as f:
        pickle.dump(results, f)
    out_dir = os.path.join(work, 'submission')
    zip_path = ds.format_results(results, out_dir)
    task1 = sorted(f for f in os.listdir(out_dir) if f.startswith('Task1_'))
    phase('eval_format', files=len(task1), zip=os.path.relpath(zip_path, root),
          zip_bytes=os.path.getsize(zip_path))
    check(len(task1) == len(ds.CLASSES) and os.path.getsize(zip_path) > 0,
          'format_results did not write a Task1 file a class and the zip')

    # the int8 serving configuration on the same weights, calibrated as
    # the test CLI's --calibrate-int8 does
    state = model.state_dict()
    del model
    torch.cuda.empty_cache()
    cfg.merge_from_options({'model.quantize_int8': 'static',
                            'model.quantize_head_int8': 'static',
                            'model.int8_act': True})
    model_q, cfg_q = build_from_config(cfg, dtype=torch.bfloat16, device=dev)
    missing, unexpected = model_q.load_state_dict(state, strict=False)
    check(not unexpected and all(k.endswith(('act_absmax', 'in_absmax'))
                                 for k in missing),
          f'state dict mismatch: {missing[:3]} {unexpected[:3]}')
    with torch.no_grad():
        calibrate(model_q, calibration_batches(ds, EVAL_CALIBRATE,
                                               EVAL_BATCH, hw, dev))
    torch.cuda.synchronize()
    _ext.reset_launches()
    q_results, _ = run(model_q, cfg_q)
    q_launches = dict(_ext.LAUNCHES)
    phase('launches', path='eval_int8', batches=batches, **q_launches)
    for name, per_step in (('rotated_iou', 1), ('frm_sample', 1),
                           ('stem_conv_pool_q8', 1),
                           ('int8_conv', INT8_QCONVS)):
        check(q_launches[name] == per_step * batches,
              f'kernel {name} ran {q_launches[name]} times in {batches} '
              f'int8 predict steps, not {per_step} a step')
    _, q_s = run(model_q, cfg_q)
    use_kernels(model_q, False)
    q_plain, _ = run(model_q, cfg_q)
    use_kernels(model_q, True)
    same = _same_results(q_results, q_plain)
    phase('eval_int8', calibrated_batches=EVAL_CALIBRATE,
          images_per_s=f'{len(ds) / q_s:.2f}',
          dets=sum(len(c) for r in q_results for c in r),
          equal_to_plain=same, card=card)
    phase('eval_ap', path='int8',
          kernel=_ap_line(ds.evaluate(q_results, logger=None)),
          plain=_ap_line(ds.evaluate(q_plain, logger=None)))
    check(same, 'the int8 eval path differs from its plain route')
    del model_q
    torch.cuda.empty_cache()
    return launches


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _patches_per_s(step, images, iters=5):
    import torch
    step(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(images)
    torch.cuda.synchronize()
    return images.shape[0] * iters / (time.perf_counter() - t0)


def profile_step(step, images, path, card, batch='big'):
    """One step under torch.profiler: the top 8 device kernels by time,
    the device's busy share of its span, and the int8 conv's and K1's
    device times.
    Returns the kernel times by name (ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(images)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(kernels, f'the profiler saw no device kernel ({path})')
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - spans[0][0]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    int8_ms = sum(v for k, v in by_name.items() if 'int8_conv' in k)
    iou_ms = sum(v for k, v in by_name.items() if 'rotated_iou' in k)
    phase('profile', path=path, batch=batch,
          device_span_ms=f'{span / 1e3:.3f}',
          busy_ms=f'{busy / 1e3:.3f}', busy_share=f'{busy / span:.3f}',
          int8_conv_ms=f'{int8_ms:.3f}', rotated_iou_ms=f'{iou_ms:.3f}',
          card=card,
          top=json.dumps([[k[:60], round(v, 3)] for k, v in top]))
    return by_name


def _check_dets(result, cfg, batch, what):
    import torch
    dets, labels, num = result[:3]
    check(tuple(dets.shape) == (batch, cfg.test.max_per_img, 6)
          and tuple(labels.shape) == (batch, cfg.test.max_per_img)
          and tuple(num.shape) == (batch,), f'wrong output shapes ({what})')
    check(bool(torch.isfinite(dets).all()), f'non-finite detections ({what})')
    check(bool((num > 0).all()), f'an image has no detection ({what})')


def _copy_model(cfg, state, dev, **kw):
    """A detector built with ``kw`` carrying ``state`` (int8 ranges may be
    absent from it: they start uncalibrated)."""
    import torch

    from r3det_tpu_torch.models.detectors import build_detector
    model = build_detector(cfg, dtype=torch.bfloat16, device=dev, **kw)
    missing, unexpected = model.load_state_dict(state, strict=False)
    check(not unexpected and all(k.endswith(('act_absmax', 'in_absmax'))
                                 for k in missing),
          f'state dict mismatch: {missing[:3]} {unexpected[:3]}')
    return model


def int8_serving(dev, card, base):
    """Phase 4, int8: the serving configuration on the bf16 path's weights,
    calibrated on the seeded batch. Returns the run's launch counts and
    the model."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.detectors import use_kernels
    from r3det_tpu_torch.models.quant import calibrate
    from r3det_tpu_torch.parallel.predict import make_predict_step

    model, images, sizes = base['model'], base['images'], base['sizes']
    cfg = base['cfg']._replace(quantize='static', quantize_head='static')
    _set_bias(model, base['biases']['big'])
    model_q = _copy_model(cfg, model.state_dict(), dev, int8_act=True,
                          stem_fused_kernel=True)
    t0 = time.perf_counter()
    calibrate(model_q, [images])
    torch.cuda.synchronize()
    phase('calibrate', seconds=f'{time.perf_counter() - t0:.2f}',
          ranges=sum(1 for k in model_q.state_dict()
                     if k.endswith(('act_absmax', 'in_absmax'))))
    step = make_predict_step(model_q, cfg, sizes, img_shape=(SIZE, SIZE))

    torch.cuda.synchronize()
    _ext.reset_launches()
    result = _with_branch(lambda: step(images))
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='int8', **launches)
    for name in PATH_KERNELS['int8']:
        check(launches[name] > 0,
              f'kernel {name} was not launched on the int8 path')
    # one launch per QConv: 16 blocks x 3 + 4 downsamples, 8 FPN convs,
    # 2 heads x 2 towers x 2 convs x 5 levels, 3 FRM convs x 5 levels
    check(launches['int8_conv'] == INT8_QCONVS,
          f'{launches["int8_conv"]} int8 conv launches, not {INT8_QCONVS}')
    check(launches['stem_conv_pool_q8'] == 1,
          'the int8 stem kernel did not run once a predict step')
    check(launches['frm_sample'] == cfg.num_refine_stages,
          'K2 did not run once a refine stage a predict step (int8)')
    _check_dets(result, cfg, BATCH, 'int8')

    q_logits = _sr_logits(model_q, images)
    bf_logits = _sr_logits(model, images)
    speed = _patches_per_s(step, images)
    bf_speed = _patches_per_s(base['step'], images)
    use_kernels(model_q, False)
    plain = step(images)
    plain_logits = _sr_logits(model_q, images)
    plain_speed = _patches_per_s(step, images)
    use_kernels(model_q, True)
    rel_bf16, rel_plain = _rel(q_logits, bf_logits), _rel(q_logits,
                                                          plain_logits)
    found, back = _agreement(result[:3], plain[:3]), \
        _agreement(plain[:3], result[:3])
    phase('int8', branch=result[3],
          num=result[2].tolist(), sr_logits_rel_to_bf16=f'{rel_bf16:.5f}',
          sr_logits_rel_to_plain=rel_plain, tol_bf16=0.05, tol_plain=0.0,
          dets_found_in_plain=f'{found:.4f}',
          plain_found_in_kernel=f'{back:.4f}',
          patches_per_s=f'{speed:.2f}', plain_patches_per_s=f'{plain_speed:.2f}',
          bf16_patches_per_s=f'{bf_speed:.2f}', card=card)
    check(rel_bf16 <= 0.05, 'int8 refine logits drift from the bf16 path')
    # every kernel of the int8 path is exact against its plain version
    check(rel_plain == 0.0, 'int8 kernel route differs from its plain route')
    check(found == back == 1.0, 'int8 kernel and plain detections differ')
    phase('stages', path='int8', batch='big', card=card,
          **{k: f'{v:.3f}' for k, v in stage_times(model_q, images,
                                                   sizes).items()})
    profile_step(step, images, 'int8', card)
    return launches, model_q


def f32_model(dev, card, base):
    """Phase 4, f32: the bf16 path's weights in an f32 model with default
    options, batch 1. The stem, int8 conv and FRM routes take their plain
    forms (their kernels compute in bf16), so only NMS's IoU kernel runs;
    forward and predict must equal the model's after use_kernels(False).
    Returns the run's launch counts."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.detectors import build_detector, use_kernels
    from r3det_tpu_torch.parallel.predict import make_predict_step

    cfg, images = base['cfg'], base['images'][:1]
    model = build_detector(cfg, dtype=torch.float32, device=dev)
    model.load_state_dict(base['model'].state_dict())
    step = make_predict_step(model, cfg, base['sizes'],
                             img_shape=(SIZE, SIZE))

    def run():
        return _sr_logits(model, images), step(images)
    torch.cuda.synchronize()
    _ext.reset_launches()
    logits, dets = run()
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='f32', **launches)
    check(all((n > 0) == (k in PATH_KERNELS['f32'])
              for k, n in launches.items()),
          'the f32 model launched a bf16 kernel, or not the IoU kernel')
    _check_dets(dets, cfg, 1, 'f32')
    use_kernels(model, False)
    plain_logits, plain_dets = run()
    use_kernels(model, True)
    same = torch.equal(logits, plain_logits) and all(
        torch.equal(a, b) for a, b in zip(dets, plain_dets))
    phase('f32', batch=1, dtype=str(logits.dtype).replace('torch.', ''),
          num=dets[2].tolist(), equal_to_plain=same, card=card)
    check(logits.dtype == torch.float32 and same,
          'the f32 model differs from its plain route')
    del model
    torch.cuda.empty_cache()
    return launches


def frm5_model(dev, card, base):
    """Phase 4, points=5: the bf16 path's weights in R3Det* with
    ``frm_points=5``, batch ROUTE_BATCH. Its FRM takes K2, one launch a
    forward for the five levels, and its refine logits and detections must
    equal the same model's with the FRM on its plain form. Returns the
    run's launch counts."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.models.frm import FeatureRefineModule
    from r3det_tpu_torch.parallel.predict import make_predict_step

    cfg, images = base['cfg'], base['images'][:ROUTE_BATCH]
    model = _copy_model(cfg, base['model'].state_dict(), dev, frm_points=5)
    step = make_predict_step(model, cfg, base['sizes'],
                             img_shape=(SIZE, SIZE))

    def run():
        return _sr_logits(model, images), step(images)
    torch.cuda.synchronize()
    _ext.reset_launches()
    logits, dets = run()
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    phase('launches', path='frm5', **launches)
    # two forward passes: the logits' and the predict step's
    check(launches['frm_sample'] == 2 * cfg.num_refine_stages,
          f'K2 ran {launches["frm_sample"]} times in two points=5 forwards')
    _check_dets(dets, cfg, ROUTE_BATCH, 'frm5')
    frms = [m for m in model.modules() if isinstance(m, FeatureRefineModule)]
    for m in frms:
        _plain_forward(m)
    plain_logits, plain_dets = run()
    same = torch.equal(logits, plain_logits) and all(
        torch.equal(a, b) for a, b in zip(dets, plain_dets))
    phase('frm5', batch=ROUTE_BATCH, points=frms[0].points,
          frm_launches=launches['frm_sample'], num=dets[2].tolist(),
          equal_to_plain=same, card=card)
    check(same, 'the points=5 FRM differs from its plain route')
    del model
    torch.cuda.empty_cache()
    return launches


def opt_in_routes(dev, base, model_q):
    """Phase 5: the opt-in backbone routes at batch ROUTE_BATCH, each held
    to the model it varies. Returns {route: launch counts}."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.parallel.predict import make_predict_step

    from r3det_tpu_torch.models.quant import calibrate

    images = base['images'][:ROUTE_BATCH]
    out = {}
    # the fused int8 block reads each conv's calibrated range; with int8_act
    # conv1 takes the block's pre-quantized input and records none (as in
    # the JAX package), so this reference calibrates without it
    ref_q = _copy_model(model_q.cfg, base['model'].state_dict(), dev)
    calibrate(ref_q, [base['images']])
    routes = (
        # bf16: fused blocks (K5), the unfused stem with the pool kernel (K4)
        ('route_bf16', base['model'], base['cfg'],
         dict(fused_blocks=True, stem_fused_kernel=False,
              stem_pool_kernel=True), 0.05),
        # int8: fused blocks with the calibrated ranges (K5 int8). The
        # fused block quantizes BN-folded weights by the reciprocal
        # multiply, so its grids differ from the unfused QConvs': the JAX
        # package's bound for one block is 0.1 of the largest value.
        ('route_int8', ref_q, model_q.cfg, dict(fused_blocks=True), 0.1))
    for route, ref, cfg, kw, tol in routes:
        model = _copy_model(cfg, ref.state_dict(), dev, **kw)
        step = make_predict_step(model, cfg, base['sizes'],
                                 img_shape=(SIZE, SIZE))
        torch.cuda.synchronize()
        _ext.reset_launches()
        result = step(images)
        torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        phase('launches', path=route, **launches)
        for name in PATH_KERNELS[route]:
            check(launches[name] > 0,
                  f'kernel {name} was not launched on {route}')
        _check_dets(result, cfg, ROUTE_BATCH, route)
        rel = _rel(_sr_logits(model, images), _sr_logits(ref, images))
        phase('route', path=route, sr_logits_rel_to_unfused=f'{rel:.5f}',
              tol=tol, patches_per_s=f'{_patches_per_s(step, images):.2f}',
              unfused_patches_per_s=f'{_patches_per_s(make_predict_step(ref, cfg, base["sizes"], img_shape=(SIZE, SIZE)), images):.2f}')
        check(rel <= tol, f'{route} drifts from the unfused model')
        out[route] = launches
        del model
    return out


def _grad_errors(got, want, names):
    """Relative L2 errors of the gradient list ``got`` against ``want``
    (None: no gradient, a frozen parameter; both must agree on it): over
    all parameters at once, and each parameter's, worst first."""
    num = den = 0.0
    per = []
    for n, a, b in zip(names, got, want):
        check((a is None) == (b is None),
              f'{n}: a gradient on one route only')
        if a is None:
            continue
        d = float((a.float() - b.float()).square().sum())
        w = float(b.float().square().sum())
        num += d
        den += w
        if w > 0:
            per.append((math.sqrt(d / w), n))
    return math.sqrt(num / den), sorted(per, reverse=True)


def train_stages(model, cfg, sizes, batch, opt, iters=3):
    """Mean ms of each part of a train step (CUDA events): the forward,
    the targets and losses, the backward and the update."""
    import torch

    from r3det_tpu_torch.models.detectors import detector_loss
    names = ('forward', 'targets_losses', 'backward', 'update')
    tot = [0.0] * len(names)
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        model.zero_grad(set_to_none=True)
        ev[0].record()
        out = model(batch['image'])
        ev[1].record()
        losses = detector_loss(out, cfg, sizes, batch['gt_bboxes'],
                               batch['gt_labels'], batch['gt_mask'])
        ev[2].record()
        losses['total'].backward()
        ev[3].record()
        opt.step([p.grad for p in model.parameters()])
        ev[4].record()
        torch.cuda.synchronize()
        for i in range(len(names)):
            tot[i] += ev[i].elapsed_time(ev[i + 1])
    return {n: tot[i] / iters for i, n in enumerate(names)}


def train_path(dev, card):
    """Phase 6: R3Det R50 as shipped, bf16 on f32 parameters, batch
    TRAIN_BATCH of 1024^2: the kernel route against the plain route on one
    step, then TRAIN_WARMUP + TRAIN_STEPS steps of make_train_step on one
    seeded batch. Returns the timed run's launch counts."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.datasets.synthetic import SyntheticDetData
    from r3det_tpu_torch.models.detectors import (R3DET_R50_V1,
                                                  build_detector,
                                                  use_kernels)
    from r3det_tpu_torch.parallel.train import (loss_and_grads,
                                                make_optimizer,
                                                make_train_step)
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    cfg = R3DET_R50_V1
    model = build_detector(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    data = SyntheticDetData(batch_size=TRAIN_BATCH, size=SIZE,
                            max_gt=TRAIN_MAX_GT, num_classes=cfg.num_classes,
                            seed=SEED).batch()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    sizes = tuple((SIZE // s, SIZE // s) for s in cfg.strides)
    names = [n for n, _ in model.named_parameters()]

    # one step's losses and gradients, kernel route against plain route
    losses, grads = loss_and_grads(model, cfg, sizes, batch)
    use_kernels(model, False)
    try:
        plain_losses, plain_grads = loss_and_grads(model, cfg, sizes, batch)
    finally:
        use_kernels(model, True)
    loss_err = {k: abs(float(losses[k]) - float(v)) / abs(float(v))
                for k, v in plain_losses.items()}
    total_err, per = _grad_errors(grads, plain_grads, names)
    frozen = sum(g is None for g in grads)
    phase('train_parity', losses=json.dumps(
              {k: float(v) for k, v in losses.items()}),
          plain_losses=json.dumps(
              {k: float(v) for k, v in plain_losses.items()}),
          loss_rel_err=json.dumps(loss_err), tol_loss=TRAIN_LOSS_RTOL,
          grad_rel_l2=f'{total_err:.6f}', tol_grad=TRAIN_GRAD_RTOL,
          worst_params=json.dumps([[n, round(e, 6)] for e, n in per[:5]]),
          tol_param=TRAIN_PARAM_RTOL, params=len(names),
          frozen_without_grad=frozen)
    check(all(math.isfinite(float(v)) for v in losses.values()),
          'a non-finite loss on the kernel route')
    check(max(loss_err.values()) <= TRAIN_LOSS_RTOL,
          'kernel-route losses drift from the plain route')
    check(total_err <= TRAIN_GRAD_RTOL,
          'kernel-route gradients drift from the plain route')
    check(per[0][0] <= TRAIN_PARAM_RTOL,
          f'the gradient of {per[0][1]} drifts from the plain route')
    # F7: each bf16 route against one f32 step of the same weights and
    # batch (an f32 model takes the plain routes)
    model.zero_grad(set_to_none=True)
    f32 = build_detector(cfg, dtype=torch.float32, device=dev)
    f32.load_state_dict(model.state_dict())
    f32_losses, f32_grads = loss_and_grads(f32, cfg, sizes, batch)
    del f32
    kernel_f32, kernel_per = _grad_errors(grads, f32_grads, names)
    plain_f32, plain_per = _grad_errors(plain_grads, f32_grads, names)
    phase('train_f32', f32_losses=json.dumps(
              {k: float(v) for k, v in f32_losses.items()}),
          kernel_grad_rel_l2=f'{kernel_f32:.6f}',
          plain_grad_rel_l2=f'{plain_f32:.6f}',
          kernel_worst=json.dumps([[n, round(e, 6)]
                                   for e, n in kernel_per[:5]]),
          plain_worst=json.dumps([[n, round(e, 6)]
                                  for e, n in plain_per[:5]]),
          nearer='kernel' if kernel_f32 < plain_f32 else 'plain', card=card)
    check(all(math.isfinite(float(v)) for v in f32_losses.values()),
          'a non-finite loss in the f32 step')
    del grads, plain_grads, f32_grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    opt = make_optimizer(model.parameters())
    step = make_train_step(model, cfg, sizes, optimizer=opt)
    history = [step(batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _ext.reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        history.append(step(batch))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = dict(_ext.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    phase('launches', path='train', steps=TRAIN_STEPS, **launches)
    for name in PATH_KERNELS['train']:
        check(launches[name] == TRAIN_STEPS,
              f'kernel {name} ran {launches[name]} times in {TRAIN_STEPS} '
              f'train steps, not once a step')
    first = {k: float(v) for k, v in history[0].items()}
    last = {k: float(v) for k, v in history[-1].items()}
    ms = sum(times) / len(times)
    phase('train', config='R3DET_R50_V1', batch=TRAIN_BATCH, size=SIZE,
          steps=f'{TRAIN_WARMUP}+{TRAIN_STEPS}',
          first=json.dumps(first), last=json.dumps(last),
          totals=json.dumps([round(float(h['total']), 5) for h in history]),
          ms_per_step=f'{ms:.3f}', ms_min=f'{min(times):.3f}',
          ms_max=f'{max(times):.3f}',
          images_per_s=f'{TRAIN_BATCH * 1e3 / ms:.2f}',
          max_memory_allocated_gb=f'{peak / 2 ** 30:.3f}',
          launches_per_step=json.dumps(
              {k: launches[k] / TRAIN_STEPS for k in PATH_KERNELS['train']}),
          card=card)
    check(all(math.isfinite(v) for h in history for v in
              (float(x) for x in h.values())), 'a non-finite train loss')
    check(last['total'] < first['total'],
          f'the total loss did not fall over {len(history)} steps on one '
          f'batch: {first["total"]} -> {last["total"]}')
    # where a step's time goes, after the timed steps
    phase('stages', path='train', batch=TRAIN_BATCH, card=card,
          **{k: f'{v:.3f}' for k, v in train_stages(
              model, cfg, sizes, batch, opt).items()})
    profile_step(step, batch, 'train', card, batch=TRAIN_BATCH)
    del model, step, history, batch, opt
    torch.cuda.empty_cache()
    return launches


def _cli_times(run, warm=TRAIN_CLI_WARMUP):
    """ms a step, images/s and the share of the loop's wall time spent
    waiting in next(loader), over a CLI run's steps after ``warm``."""
    iters, waits = run['iter_s'][warm:], run['wait_s'][warm:]
    ms = 1e3 * sum(iters) / len(iters)
    return ms, TRAIN_BATCH * 1e3 / ms, sum(waits) / sum(iters)


def train_cli_path(dev, card):
    """Phase 7 ([train_cli]): the train CLI from DOTA files. Run 1: R3Det
    R50 as shipped, batch 2 of 1024^2, TRAIN_CLI_STEPS[0] steps with the
    eval hook at the end, a checkpoint restored into a new model bit for
    bit, then resumed to TRAIN_CLI_STEPS[1] (the timed run; K1, K2, K2's
    backward and K3 once a step). Run 2: rotated RetinaNet with
    PolyRandomRotate (v3), whose first batch from the card's pipeline
    equals the CPU's. Returns the resumed run's launch counts."""
    import tempfile

    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.parallel.train import (make_optimizer,
                                                make_train_step)
    from r3det_tpu_torch.tools import make_fake_dota
    from r3det_tpu_torch.tools import train as train_cli
    from r3det_tpu_torch.utils.builder import (build_from_config,
                                               detector_config_from_dict)
    from r3det_tpu_torch.utils.checkpoint import restore_checkpoint
    from r3det_tpu_torch.utils.config import Config

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix='train_cli_') as work:
        raw, split = os.path.join(work, 'raw'), os.path.join(work, 'split')
        make_fake_dota.main(['--out', raw, '--split-out', split,
                             '--num-images', str(EVAL_IMAGES)])
        data = [f'data.{s}.{k}={split}/{d}/' for s in ('train', 'val')
                for k, d in (('ann_file', 'annfiles'),
                             ('img_prefix', 'images'))]

        def argv(config, out, *extra, options=()):
            return [os.path.join(root, config), '--work-dir', out,
                    '--log-interval', '1', '--seed', str(SEED), *extra,
                    '--cfg-options', *data, *options]

        # run 1: 4 steps, a checkpoint at the end, then the eval hook
        first = train_cli.main(argv(
            TRAIN_CLI_CONFIG, os.path.join(work, 'run1'), '--max-steps',
            str(TRAIN_CLI_STEPS[0]), options=['checkpoint_config.interval=1',
                                              'evaluation.interval=1']))
        ckpt = os.path.join(work, 'run1', 'ckpt',
                            f'step_{TRAIN_CLI_STEPS[0]}.pt')
        check(os.path.exists(ckpt) and first['metrics'] is not None,
              'run 1 wrote no checkpoint or ran no eval hook')
        check(all(math.isfinite(h['total']) for h in first['history']),
              'a non-finite loss in run 1')
        first_map = first['metrics']['mAP']
        saved = {k: v.detach().clone()
                 for k, v in first['model'].state_dict().items()}
        saved_trace = [t.clone() for t in first['optimizer'].trace]
        saved_count = first['optimizer'].count
        first_times = _cli_times(first)
        cfg = Config.fromfile(os.path.join(root, TRAIN_CLI_CONFIG))
        cfg.merge_from_options(dict(kv.split('=', 1) for kv in data))
        del first
        torch.cuda.empty_cache()

        # the checkpoint into a new model and optimizer, bit for bit
        model, det_cfg = build_from_config(cfg, dtype=torch.bfloat16,
                                           device=dev)
        opt = make_optimizer(model.parameters())
        step_at = restore_checkpoint(ckpt, model, opt)
        restored = (step_at == TRAIN_CLI_STEPS[0] and
                    opt.count == saved_count == TRAIN_CLI_STEPS[0] and
                    all(torch.equal(v, saved[k])
                        for k, v in model.state_dict().items()) and
                    all(torch.equal(a, b) for a, b in
                        zip(opt.trace, saved_trace)))
        del model, opt, saved, saved_trace
        torch.cuda.empty_cache()
        check(restored, 'the restored state differs from the saved one')

        # resumed to step 8: the timed run, its launches counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _ext.reset_launches()
        second = train_cli.main(argv(
            TRAIN_CLI_CONFIG, os.path.join(work, 'run1b'), '--max-steps',
            str(TRAIN_CLI_STEPS[1]), '--resume-from', ckpt,
            options=['evaluation.interval=0']))
        torch.cuda.synchronize()
        launches = dict(_ext.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        steps = TRAIN_CLI_STEPS[1] - TRAIN_CLI_STEPS[0]
        phase('launches', path='train_cli', steps=steps, **launches)
        for name in PATH_KERNELS['train']:
            check(launches[name] == steps,
                  f'kernel {name} ran {launches[name]} times in {steps} '
                  'train CLI steps, not once a step')
        hist = second['history']
        check([h['step'] for h in hist] ==
              list(range(TRAIN_CLI_STEPS[0] + 1, TRAIN_CLI_STEPS[1] + 1)) and
              second['optimizer'].count == TRAIN_CLI_STEPS[1] and
              all(h['lr'] == second['optimizer'].lr_schedule(h['step'])
                  for h in hist),
              'the resumed run did not continue the step, count and LR')
        check(all(math.isfinite(v) for h in hist for k, v in h.items()
                  if k != 'step'), 'a non-finite train CLI loss')
        ms, ips, wait = _cli_times(second)

        # one profiled iteration: the loader's next batch and a step
        step = make_train_step(second['model'], det_cfg,
                               tuple((SIZE // s, SIZE // s)
                                     for s in det_cfg.strides),
                               optimizer=second['optimizer'], device=dev)
        loader, _, _ = train_cli.build_train_loader(
            cfg, det_cfg, TRAIN_BATCH, SEED, dev)
        it = iter(loader)
        profile_step(lambda _: step(next(it)), None, 'train_cli', card,
                     batch=TRAIN_BATCH)
        it.close()
        phase('train_cli', config=TRAIN_CLI_CONFIG, batch=TRAIN_BATCH,
              size=SIZE, steps=f'{TRAIN_CLI_STEPS[0]}+'
              f'{steps} (resumed at {step_at})',
              ms_per_step=f'{ms:.3f}', images_per_s=f'{ips:.2f}',
              loader_wait_share=f'{wait:.4f}',
              run1_ms_per_step=f'{first_times[0]:.3f}',
              run1_loader_wait_share=f'{first_times[2]:.4f}',
              timed_steps=len(second['iter_s']) - TRAIN_CLI_WARMUP,
              max_memory_allocated_gb=f'{peak / 2 ** 30:.3f}',
              losses=json.dumps([round(h['total'], 5) for h in hist]),
              run1_val_map=f'{first_map:.4f}', card=card)
        del second, step, loader, it
        torch.cuda.empty_cache()

        # run 2: PolyRandomRotate (v3); the card's first batch is the CPU's
        rcfg = Config.fromfile(os.path.join(root, TRAIN_CLI_ROTATE))
        rcfg.merge_from_options(dict(kv.split('=', 1) for kv in data))
        rdet = detector_config_from_dict(rcfg.to_dict()['model'])
        batches = []
        for d in (dev, 'cpu'):
            loader, _, _ = train_cli.build_train_loader(
                rcfg, rdet, TRAIN_BATCH, SEED, d)
            it = iter(loader)
            batches.append({k: v.cpu() for k, v in next(it).items()})
            it.close()
        same_img = torch.equal(batches[0]['image'], batches[1]['image'])
        same_gt = all(torch.equal(batches[0][k], batches[1][k])
                      for k in ('gt_bboxes', 'gt_labels', 'gt_mask'))
        rot = train_cli.main(argv(
            TRAIN_CLI_ROTATE, os.path.join(work, 'run2'), '--max-steps',
            '4', options=['evaluation.interval=0']))
        phase('train_cli_rotate', config=TRAIN_CLI_ROTATE,
              batch=TRAIN_BATCH, steps=rot['step'],
              card_equals_cpu_image=same_img, card_equals_cpu_gt=same_gt,
              gt=int(batches[0]['gt_mask'].sum()),
              losses=json.dumps([round(h['total'], 5)
                                 for h in rot['history']]), card=card)
        check(same_img and same_gt, "the card's train pipeline differs "
              "from the CPU's on the first batch")
        check(all(math.isfinite(h['total']) for h in rot['history']),
              'a non-finite loss in the rotation run')
        del rot
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: data parallelism
# ---------------------------------------------------------------------------

def _run_ranks(cmds, what, timeout=DDP_TIMEOUT):
    """Start every command at once, each in a session of its own, its
    output in a file; wait until all have exited, one has failed or the
    timeout has passed, then kill every process of each session still
    running. Raises unless every command exited 0 (printing the end of a
    failed one's output); returns their outputs."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix='ranks_') as logs:
        files = [open(os.path.join(logs, f'{i}.log'), 'w+')
                 for i in range(len(cmds))]
        procs = [subprocess.Popen(c, cwd=root, env=env, stdout=f,
                                  stderr=subprocess.STDOUT,
                                  start_new_session=True)
                 for c, f in zip(cmds, files)]
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if any(codes) or None not in codes:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                    p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        # the first that failed by itself, not one killed here
        i = min((i for i, c in enumerate(codes) if c),
                key=lambda i: codes[i] == -9)
        print(outs[i][-3000:], flush=True)
        raise RuntimeError(f'{what}: exit codes {codes}')
    return outs


def ddp_worker(spec):
    """One rank of [ddp_step] / [ddp_nccl] (``chip_smoke.py --ddp-worker
    SPEC``): R3Det R50 (``spec['cfg']`` overrides), bf16 on f32
    parameters, seeded weights broadcast from rank 0, its rows of one
    SyntheticDetData batch of ``spec['batch']``, DDP_STEPS steps of the
    data-parallel make_train_step. Writes losses, ms a step, the
    all-reduce's ms (timed apart on the last step's gradients), peak
    memory, launches and whether the ranks' parameters were bit-identical
    after each step (a checksum all-gather); rank 0 also its parameters."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.datasets.synthetic import SyntheticDetData
    from r3det_tpu_torch.models.detectors import (R3DET_R50_V1,
                                                  build_detector)
    from r3det_tpu_torch.parallel import dist
    from r3det_tpu_torch.parallel.train import (make_optimizer,
                                                make_train_step)
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, ranks = spec['rank'], spec['ranks']
    dev = torch.device('cuda', spec['device'])
    torch.cuda.set_device(dev)
    group = dist.init_distributed(spec['backend'], 'file://' + spec['store'],
                                  ranks, rank, timeout_s=DDP_TIMEOUT)
    try:
        cfg = R3DET_R50_V1._replace(**spec['cfg'])
        size = spec['size']
        model = build_detector(cfg, dtype=torch.bfloat16, device=dev)
        model.load_state_dict(seeded_state_dict(model, SEED + rank))
        opt = make_optimizer(model.parameters())
        dist.broadcast_state(model, opt, group)       # rank 0's weights
        local = spec['batch'] // ranks
        data = SyntheticDetData(batch_size=spec['batch'], size=size,
                                max_gt=TRAIN_MAX_GT,
                                num_classes=cfg.num_classes,
                                seed=SEED).batch()
        batch = {k: torch.from_numpy(v[rank * local:(rank + 1) * local])
                 .to(dev) for k, v in data.items()}
        sizes = tuple((size // s, size // s) for s in cfg.strides)
        step = make_train_step(model, cfg, sizes, optimizer=opt,
                               process_group=group)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _ext.reset_launches()
        losses, ms, same = [], [], []
        for _ in range(DDP_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append({k: float(v) for k, v in out.items()})
            sums = dist.gather_objects(
                dist.checksum(list(model.parameters()) + opt.trace), group)
            same.append(all(torch.equal(s, sums[0]) for s in sums))
        launches = dict(_ext.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        grads = [p.grad for p in model.parameters()]
        ar = []
        for _ in range(3):
            dist.barrier(group)
            t0 = time.perf_counter()
            dist.all_reduce_grads(grads, model.parameters(), group)
            torch.cuda.synchronize()
            ar.append(1e3 * (time.perf_counter() - t0))
        out = dict(losses=losses, ms=ms, same=same, launches=launches,
                   peak=peak, allreduce_ms=sorted(ar)[1],
                   name=torch.cuda.get_device_name(dev))
        if rank == 0:
            out['params'] = {n: p.detach().cpu()
                             for n, p in model.named_parameters()}
        torch.save(out, spec['out'])
    finally:
        torch.distributed.destroy_process_group()
    return 0


def ddp_reference(dev, cfg_overrides=None, size=SIZE, batch=DDP_BATCH):
    """The single process [ddp_step] and [ddp_nccl] are held to: the same
    seeded model and the whole batch, DDP_STEPS steps on ``dev``. Returns
    (losses a step, the parameters before and after, on the host)."""
    import torch

    from r3det_tpu_torch.datasets.synthetic import SyntheticDetData
    from r3det_tpu_torch.models.detectors import (R3DET_R50_V1,
                                                  build_detector)
    from r3det_tpu_torch.parallel.train import make_train_step
    from r3det_tpu_torch.utils.convert import seeded_state_dict

    cfg = R3DET_R50_V1._replace(**(cfg_overrides or {}))
    model = build_detector(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(seeded_state_dict(model, SEED))
    p0 = {n: p.detach().cpu() for n, p in model.named_parameters()}
    data = SyntheticDetData(batch_size=batch, size=size, max_gt=TRAIN_MAX_GT,
                            num_classes=cfg.num_classes, seed=SEED).batch()
    b = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    step = make_train_step(model, cfg, tuple((size // s, size // s)
                                             for s in cfg.strides))
    losses = [{k: float(v) for k, v in step(b).items()}
              for _ in range(DDP_STEPS)]
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, step, b
    torch.cuda.empty_cache()
    return losses, p0, params


def ddp_step(ranks, backend, devices, reference, work, cfg_overrides=None,
             size=SIZE, batch=DDP_BATCH):
    """``ranks`` ranks of ddp_worker over ``backend`` on ``devices`` (one
    card index a rank) against ``reference`` (ddp_reference's): each
    step's losses within TRAIN_LOSS_RTOL, the parameters after the last
    within TRAIN_GRAD_RTOL of the update (relative L2 over all
    parameters), the ranks bit-identical after every step, K1, K2, K2's
    backward and K3 once a step on every rank. Returns rank 0's record
    with the errors and every rank's peak memory."""
    import torch

    want_losses, p0, want = reference
    tag = f'{backend}{ranks}'
    outs = [os.path.join(work, f'{tag}_rank{r}.pt') for r in range(ranks)]
    cmds = [[sys.executable, os.path.abspath(__file__), '--ddp-worker',
             json.dumps(dict(rank=r, ranks=ranks, backend=backend,
                             device=devices[r], batch=batch, size=size,
                             cfg=cfg_overrides or {},
                             store=os.path.join(work, f'{tag}_store'),
                             out=outs[r]))] for r in range(ranks)]
    _run_ranks(cmds, f'{ranks} {backend} ranks')
    recs = [torch.load(p, weights_only=False) for p in outs]
    rec = recs[0]
    loss_err = max(abs(g[k] - w[k]) / abs(w[k])
                   for g, w in zip(rec['losses'], want_losses) for k in w)
    num = sum(float((rec['params'][n] - w).square().sum())
              for n, w in want.items())
    den = sum(float((w - p0[n]).square().sum()) for n, w in want.items())
    rec.update(loss_err=loss_err, param_err=math.sqrt(num / den),
               peaks=[r['peak'] for r in recs],
               same=all(s for r in recs for s in r['same']))
    check(all(math.isfinite(v) for h in rec['losses'] for v in h.values()),
          f'{tag}: a non-finite loss')
    check(loss_err <= TRAIN_LOSS_RTOL,
          f'{tag}: losses {loss_err:.5f} from the single process')
    check(rec['param_err'] <= TRAIN_GRAD_RTOL,
          f'{tag}: parameters {rec["param_err"]:.5f} (of the update) from '
          'the single process')
    check(rec['same'], f'{tag}: the ranks\' parameters differ')
    for r, x in enumerate(recs):
        for name in PATH_KERNELS['train']:
            check(x['launches'][name] == DDP_STEPS,
                  f'{tag} rank {r}: kernel {name} ran '
                  f'{x["launches"][name]} times in {DDP_STEPS} steps')
    return rec


def _log_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def kernel_bench_phase(card):
    """``tools/kernel_bench.py all`` on the card ([kernel_bench]): every
    int8 parity exact, K3 bf16 within one bf16 ulp, K5 bf16 within
    0.03125, K2, K4 and the conv epilogue exact, Swin's two kernels within
    2^-5 (the card test's bound: a bf16 ulp of LN outputs up to 4, P's
    rounding on unit-normal v); each variant's ms at batch 32 (Swin's at
    batch 8)."""
    from r3det_tpu_torch.tools import kernel_bench

    t0 = time.perf_counter()
    out = kernel_bench.main(['all'])
    seconds = time.perf_counter() - t0
    par = {k: v for r in out.values() for k, v in r['parity'].items()}
    ulps = out['stem']['ulps']['K3 bf16 vs plain (b1)']
    ms = {**{k: v['ms'] for k, v in out['stem']['ms'].items()},
          **{f'{t} {k}': v['ms'] for t, r in out['bottleneck']['ms'].items()
             for k, v in r.items()},
          **{f'C2 {k}': v['ms']
             for k, v in out['bottleneck']['epilogue'].items()},
          **{k: v['ms'] for k, v in out['frm']['ms'].items()},
          **{f'{t} {k}': v['ms'] for t, r in out['swin']['ms'].items()
             for k, v in r.items()}}
    phase('kernel_bench', seconds=f'{seconds:.2f}', batch=kernel_bench.BATCH,
          k3_bf16_ulps=ulps, parity=json.dumps(par),
          ms=json.dumps({k: round(v, 4) for k, v in ms.items()}), card=card)
    for name, d in par.items():
        if 'q8' in name or 'int8' in name or 'K2' in name or 'K4' in name \
                or 'epilogue' in name:
            check(d == 0.0, f'kernel_bench parity[{name}] = {d}, not 0')
        elif 'K5' in name:
            check(d <= 0.03125, f'kernel_bench parity[{name}] = {d}')
        elif 'swin' in name:
            check(d <= 2 ** -5, f'kernel_bench parity[{name}] = {d}')
    check(sum('swin' in name for name in par) == 8,
          'kernel_bench: not every Swin parity was taken')
    check(ulps <= 1.0, f'kernel_bench: K3 bf16 {ulps} ulps from its plain '
                       'version')


def vis_path(dev, card):
    """The drawing tools on the [eval] phase's split ([vis]):
    ``analyze_results --topk VIS_TOPK`` on its results pickle writes
    ``bad/`` and ``good/`` PNGs named ``{mAP:.3f}_{id}.png`` that decode;
    ``browse_dataset --limit VIS_LIMIT`` on the card draws what it draws
    with ``--device cpu``, PNG for PNG. The train pipeline is the
    config's with ``flip_ratio=1.0``: its flips draw from an unseeded
    generator, so only a pipeline that draws nothing at random gives both
    runs the same images."""
    import numpy as np

    from r3det_tpu_torch.datasets.image_io import imread
    from r3det_tpu_torch.tools import analyze_results, browse_dataset

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, 'build', 'eval_smoke')
    split = os.path.join(work, 'split')
    cfg = os.path.join(work, 'vis_config.py')
    with open(cfg, 'w') as f:
        f.write(f"""_base_ = [{os.path.join(root, EVAL_CONFIG)!r}]
data = dict(
    train=dict(
        ann_file={split + '/annfiles/'!r}, img_prefix={split + '/images/'!r},
        pipeline=[dict(type='RResize', img_scale=(1024, 1024)),
                  dict(type='RRandomFlip', flip_ratio=1.0),
                  dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                       std=[58.395, 57.12, 57.375], to_rgb=True),
                  dict(type='Pad', size_divisor=32)]),
    val=dict(ann_file={split + '/annfiles/'!r},
             img_prefix={split + '/images/'!r}))
""")
    t0 = time.perf_counter()
    shown = os.path.join(work, 'analyze')
    analyze_results.main([cfg, os.path.join(work, 'results.pkl'),
                          '--show-dir', shown, '--topk', str(VIS_TOPK)])
    analyze_s = time.perf_counter() - t0
    ids = {os.path.splitext(f)[0] for f in os.listdir(split + '/annfiles')}
    names = {tag: sorted(os.listdir(os.path.join(shown, tag)))
             for tag in ('bad', 'good')}
    maps = {}
    for tag, files in names.items():
        check(len(files) == VIS_TOPK, f'analyze_results wrote {files} to '
                                      f'{tag}/, not {VIS_TOPK} files')
        for name in files:
            m = re.fullmatch(r'(\d\.\d{3})_(.+)\.png', name)
            check(m is not None and m.group(2) in ids and
                  0.0 <= float(m.group(1)) <= 1.0,
                  f'analyze_results wrote {tag}/{name}')
            img = imread(os.path.join(shown, tag, name))
            check(img is not None and img.ndim == 3 and img.shape[2] == 3,
                  f'{tag}/{name} does not decode')
            maps.setdefault(tag, []).append(float(m.group(1)))
    check(max(maps['bad']) <= min(maps['good']),
          'analyze_results: a bad image scores above a good one')

    t0 = time.perf_counter()
    browsed = {}
    for where in ('cuda', 'cpu'):
        out = os.path.join(work, f'browse_{where}')
        browse_dataset.main([cfg, '--output-dir', out, '--limit',
                             str(VIS_LIMIT), '--device', where])
        browsed[where] = {f: imread(os.path.join(out, f))
                          for f in sorted(os.listdir(out))}
    browse_s = time.perf_counter() - t0
    same = browsed['cuda'].keys() == browsed['cpu'].keys() and all(
        np.array_equal(browsed['cuda'][f], browsed['cpu'][f])
        for f in browsed['cuda'])
    phase('vis', analyze_s=f'{analyze_s:.2f}', bad=json.dumps(names['bad']),
          good=json.dumps(names['good']), browse_s=f'{browse_s:.2f}',
          browsed=len(browsed['cuda']), card_equals_cpu=same, card=card)
    check(len(browsed['cuda']) == VIS_LIMIT,
          f'browse_dataset drew {len(browsed["cuda"])} images, not '
          f'{VIS_LIMIT}')
    check(same, 'browse_dataset on the card differs from the CPU')


def dryrun_phase(dev, card):
    """``dryrun.entry()`` on the card ([dryrun]): K3 and K2 launch (K2
    once a refine stage) and every sum is finite; then
    ``dryrun_multichip(2)`` on the CPU."""
    import torch

    from r3det_tpu_torch import _ext
    from r3det_tpu_torch.dryrun import dryrun_multichip, entry
    from r3det_tpu_torch.models.detectors import R3DET_R50_V1

    t0 = time.perf_counter()
    fn, args = entry()
    torch.cuda.synchronize()
    _ext.reset_launches()
    sums = fn(*args)
    torch.cuda.synchronize()
    launches = dict(_ext.LAUNCHES)
    entry_s = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(v)) for v in sums)
    t0 = time.perf_counter()
    dryrun_multichip(2)
    multichip_s = time.perf_counter() - t0
    phase('dryrun', entry_s=f'{entry_s:.2f}', sums=len(sums), finite=finite,
          stem_conv_pool=launches['stem_conv_pool'],
          frm_sample=launches['frm_sample'],
          multichip_s=f'{multichip_s:.2f}', card=card)
    check(finite, 'dryrun entry: non-finite sums')
    check(launches['stem_conv_pool'] >= 1 and launches['frm_sample'] >=
          R3DET_R50_V1.num_refine_stages,
          f'dryrun entry: K3 ran {launches["stem_conv_pool"]} times, K2 '
          f'{launches["frm_sample"]}')


def ddp_path(dev, card):
    """Phase 8: [ddp_step], [ddp_nccl], [ddp_cli], [ddp_eval]."""
    import pickle
    import tempfile

    import torch

    from r3det_tpu_torch.datasets.dota import DOTADataset
    from r3det_tpu_torch.parallel.train import make_lr_schedule
    from r3det_tpu_torch.tools import make_fake_dota
    from r3det_tpu_torch.utils.config import Config

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix='ddp_') as work:
        reference = ddp_reference(dev)
        rec = ddp_step(DDP_RANKS, 'gloo', [0] * DDP_RANKS, reference, work)
        phase('ddp_step', config='R3DET_R50_V1', ranks=DDP_RANKS,
              backend='gloo', device='cuda:0 (shared)',
              batch=f'{DDP_BATCH} = {DDP_RANKS} x {DDP_BATCH // DDP_RANKS}',
              size=SIZE, steps=DDP_STEPS,
              losses=json.dumps([round(h['total'], 5)
                                 for h in rec['losses']]),
              loss_rel_err=f'{rec["loss_err"]:.6f}', tol_loss=TRAIN_LOSS_RTOL,
              param_rel_l2_of_update=f'{rec["param_err"]:.6f}',
              tol_param=TRAIN_GRAD_RTOL, ranks_bit_identical=rec['same'],
              ms_per_step=f'{rec["ms"][-1]:.3f}',
              allreduce_ms=f'{rec["allreduce_ms"]:.3f}',
              peak_gb_per_rank=json.dumps([round(p / 2 ** 30, 3)
                                           for p in rec['peaks']]),
              note='two ranks sharing one card over gloo check the '
                   'function, not data-parallel speed', card=card)

        count = torch.cuda.device_count()
        ranks = max(n for n in (1, 2, 4)
                    if n <= count and DDP_BATCH % n == 0)
        rec = ddp_step(ranks, 'nccl', list(range(ranks)), reference, work)
        del reference
        phase('ddp_nccl', world_size=ranks, cards=count, backend='nccl',
              batch=f'{DDP_BATCH} = {ranks} x {DDP_BATCH // ranks}',
              steps=DDP_STEPS,
              loss_rel_err=f'{rec["loss_err"]:.6f}', tol_loss=TRAIN_LOSS_RTOL,
              param_rel_l2_of_update=f'{rec["param_err"]:.6f}',
              tol_param=TRAIN_GRAD_RTOL, ranks_bit_identical=rec['same'],
              ms_per_step=f'{rec["ms"][-1]:.3f}',
              allreduce_ms=f'{rec["allreduce_ms"]:.3f}',
              peak_gb_per_rank=json.dumps([round(p / 2 ** 30, 3)
                                           for p in rec['peaks']]),
              card=card)

        # the train CLI under torchrun: 2 ranks on card 0 over gloo
        raw, split = os.path.join(work, 'raw'), os.path.join(work, 'split')
        make_fake_dota.main(['--out', raw, '--split-out', split,
                             '--num-images', str(EVAL_IMAGES)])
        data = [f'data.{s}.{k}={split}/{d}/' for s in ('train', 'val', 'test')
                for k, d in (('ann_file', 'annfiles'),
                             ('img_prefix', 'images'))]
        torchrun = [sys.executable, '-m', 'torch.distributed.run',
                    '--standalone', '--nproc_per_node', str(DDP_RANKS)]
        dist_args = ['--launcher', 'pytorch', '--dist-backend', 'gloo',
                     '--device', 'cuda:0']

        def train(out, steps, *extra, options=()):
            t0 = time.perf_counter()
            _run_ranks([torchrun + [
                '-m', 'r3det_tpu_torch.tools.train',
                os.path.join(root, TRAIN_CLI_CONFIG), *dist_args,
                '--work-dir', out, '--max-steps', str(steps),
                '--log-interval', '1', '--seed', str(SEED), *extra,
                '--cfg-options', *data, *options]], 'the train CLI')
            return time.perf_counter() - t0

        run1, run2 = os.path.join(work, 'cli1'), os.path.join(work, 'cli2')
        s1 = train(run1, DDP_CLI_STEPS[0],
                   options=['evaluation.interval=1'])
        ckpt = os.path.join(run1, 'ckpt', f'step_{DDP_CLI_STEPS[0]}.pt')
        s2 = train(run2, DDP_CLI_STEPS[1], '--resume-from', ckpt,
                   options=['evaluation.interval=0'])
        first, second = (_log_records(os.path.join(r, 'train_log.jsonl'))
                         for r in (run1, run2))
        check(sorted(os.listdir(run1)) == ['ckpt', 'train_log.jsonl'] and
              os.listdir(os.path.join(run1, 'ckpt')) ==
              [os.path.basename(ckpt)],
              'the train CLI wrote other files than rank 0\'s log and '
              'checkpoint')
        check([r['step'] for r in first] ==
              list(range(1, DDP_CLI_STEPS[0] + 1)) + [DDP_CLI_STEPS[0]],
              'run 1 logged other steps than one record a step and one '
              'eval (rank 0 alone logs)')
        cfg = Config.fromfile(os.path.join(root, TRAIN_CLI_CONFIG))
        sched = make_lr_schedule(
            base_lr=cfg.optimizer.lr, warmup_iters=cfg.lr_config.warmup_iters,
            warmup_ratio=cfg.lr_config.warmup_ratio,
            step_epochs=cfg.lr_config.step, iters_per_epoch=1000)
        last = torch.load(os.path.join(run2, 'ckpt',
                                       f'step_{DDP_CLI_STEPS[1]}.pt'),
                          weights_only=True)
        check([r['step'] for r in second] ==
              list(range(DDP_CLI_STEPS[0] + 1, DDP_CLI_STEPS[1] + 1)) and
              all(r['lr'] == sched(r['step']) for r in second) and
              last['count'] == last['step'] == DDP_CLI_STEPS[1],
              'the resumed run did not continue the step, count and LR')
        check(all(math.isfinite(r['total']) for r in first + second
                  if 'total' in r), 'a non-finite loss in the train CLI')
        val = [r for r in first if r.get('mode') == 'val'][0]
        phase('ddp_cli', config=TRAIN_CLI_CONFIG, ranks=DDP_RANKS,
              backend='gloo', device='cuda:0 (shared)',
              batch=f'{DDP_RANKS} x {TRAIN_BATCH}',
              steps=f'{DDP_CLI_STEPS[0]}+'
              f'{DDP_CLI_STEPS[1] - DDP_CLI_STEPS[0]} (resumed)',
              run1_s=f'{s1:.1f}', run2_s=f'{s2:.1f}',
              imgs_per_sec_logged=json.dumps(
                  [r['imgs_per_sec'] for r in first + second
                   if 'imgs_per_sec' in r]),
              losses=json.dumps([round(r['total'], 5) for r in first + second
                                 if 'total' in r]),
              run1_val_map=f'{val["mAP"]:.4f}', card=card)

        # the test CLI on that checkpoint: 2 ranks, then 1
        weights = os.path.join(run2, 'ckpt', f'step_{DDP_CLI_STEPS[1]}.pt')
        test = ['-m', 'r3det_tpu_torch.tools.test',
                os.path.join(root, TRAIN_CLI_CONFIG), weights, '--eval',
                'mAP', '--batch-size', str(TRAIN_BATCH), '--cfg-options',
                *data, f'test_cfg.score_thr={DDP_SCORE_THR}']
        results, secs = [], []
        for n in (DDP_RANKS, 1):
            out = os.path.join(work, f'results{n}.pkl')
            cmd = (torchrun[:-1] + [str(n)] + test + ['--out', out] +
                   dist_args if n > 1 else
                   [sys.executable] + test + ['--out', out])
            t0 = time.perf_counter()
            _run_ranks([cmd], f'the test CLI on {n} ranks')
            secs.append(time.perf_counter() - t0)
            with open(out, 'rb') as f:
                results.append(pickle.load(f))
        ds = DOTADataset(f'{split}/annfiles/', f'{split}/images/',
                         version='v1', filter_empty=False,
                         classes=cfg.data.test.get('classes'))
        check(all(len(r) == len(ds) for r in results) and
              all(x is not None for r in results for x in r),
              'the gathered results miss an image')
        dets = sum(len(c) for r in results[1] for c in r)
        agree = _agreement(_padded_results(results[0]),
                           _padded_results(results[1]))
        maps = [ds.evaluate(r, logger=None)['mAP'] for r in results]
        phase('ddp_eval', config=TRAIN_CLI_CONFIG, images=len(ds),
              ranks=f'{DDP_RANKS} (gloo, cuda:0) vs 1',
              score_thr=DDP_SCORE_THR, detections=dets,
              agreement=f'{agree:.4f}', tol=0.75,
              map_2_ranks=f'{maps[0]:.4f}', map_1_rank=f'{maps[1]:.4f}',
              seconds=json.dumps([round(s, 1) for s in secs]), card=card)
        check(dets > 0, 'the test CLI found no detection to compare')
        check(agree >= 0.75, 'the 2-rank results disagree with the '
              '1-rank results')


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from r3det_tpu_torch import _ext

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    phase('device', name=repr(name), count=count)
    print(smi, flush=True)

    t0 = time.perf_counter()
    path = _ext.build()
    _ext.lib()
    phase('build', seconds=f'{time.perf_counter() - t0:.2f}',
          library=os.path.relpath(path))

    rec = compare_kernels(dev)
    base = end_to_end(dev, smi)
    launches = {'bf16': base['launches'], 'swin': swin_forward(dev, smi),
                'lsk': lsk_forward(dev, smi)}
    launches['stream'] = nms_stream(dev, smi, base)
    launches['nms_family'] = nms_family(dev, smi)
    launches['int8'], model_q = int8_serving(dev, smi, base)
    launches['eval'] = eval_path(dev, smi)
    launches['f32'] = f32_model(dev, smi, base)
    launches['frm5'] = frm5_model(dev, smi, base)
    launches['frm_fused'] = frm_options(dev, smi, base)
    launches.update(opt_in_routes(dev, base, model_q))
    del base, model_q
    torch.cuda.empty_cache()
    launches['train'] = train_path(dev, smi)
    launches['hbb_train'] = hbb_train(dev, smi)
    launches['train_cli'] = train_cli_path(dev, smi)
    ddp_path(dev, smi)
    kernel_bench_phase(smi)
    vis_path(dev, smi)
    dryrun_phase(dev, smi)
    kernels = [dict(name=k, route='cuda', source=SOURCES[k],
                    replaces=REPLACES[k], launches=launches[PATH_OF[k]][k],
                    max_abs_err=rec[k]['max_abs_err'], ms=rec[k]['ms'],
                    plain_ms=rec[k]['plain_ms'], bound_ms=rec[k]['bound_ms'],
                    bound_by=rec[k]['bound_by'],
                    library_ms=rec[k].get('library_ms'))
               for k in SOURCES]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': count}}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--ddp-worker']:     # one rank of phase 8
        sys.exit(ddp_worker(json.loads(sys.argv[2])))
    sys.exit(main())
