"""The benchmark's work counters: FLOPs of a step, K1's and K3's work and
the least time on the card."""
import pytest
import torch

from conftest import tiny_config

from portbench.work import flops, kernels


def r50(name='r3det_r50'):
    import json

    from conftest import PB
    return json.loads((PB / 'configs' / f'{name}.json').read_text())


def test_resnet50_at_224_is_4_1_gmac():
    macs = sum(m for n, m, _, _ in flops.convs(r50(), 224, 224)
               if n.startswith(('stem', 'layer')))
    # torchvision's ResNet-50: 4.09 GMAC with its 2048 x 1000 classifier
    assert macs + 2048 * 1000 == pytest.approx(4.09e9, rel=0.005)


def test_shipped_configs_at_1024():
    assert flops.forward_flops(r50(), 1024) == pytest.approx(669.7e9,
                                                             rel=1e-3)
    assert flops.forward_flops(r50('rretinanet_obb_r50'), 1024) == \
        pytest.approx(430.3e9, rel=1e-3)
    fwd, tr = flops.forward_flops(r50(), 1024), flops.train_flops(r50(), 1024)
    assert 2.5 * fwd < tr < 3 * fwd


def traced_conv_flops(model, x):
    """Convolution FLOPs the program runs, counted by PyTorch."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x)
    return sum(v for k, v in fc.get_flop_counts()['Global'].items()
               if 'convolution' in str(k))


@pytest.mark.parametrize('name', ['r3det_r50', 'rretinanet_obb_r50'])
@pytest.mark.parametrize('switches', [
    dict(kernels=False),
    dict(kernels=True, stem_fused_kernel=False, stem_pool_kernel=True),
    dict(kernels=True, fused_blocks=True)])
def test_counter_matches_the_program_with_switches_on_or_off(name, switches):
    """The counter works from the configuration alone, so the program's
    kernel switches cannot move it; and it counts what the program
    computes, bar the stem, which the program runs folded as a 4x4 conv
    of 12 channels (192 taps against the 7x7 conv's 147)."""
    from r3det_tpu_torch.models.detectors import build_detector

    from portbench.bench import common
    cfg = tiny_config(name)
    model = build_detector(common.program_config(cfg), dtype=torch.float32,
                           device='cpu', **cfg['build_options'], **switches)
    x = torch.zeros(1, 128, 128, 3)
    got = traced_conv_flops(model, x)
    stem = 2 * 64 * 64 * 64 * 147
    folded = 2 * 64 * 64 * 64 * 192
    assert got - folded + stem == flops.forward_flops(cfg, 128)


def test_train_counts_backward_of_trainable_layers_only():
    cfg = r50()
    fwd = flops.forward_flops(cfg, 512)
    frozen = dict(cfg, frozen_stages=4)
    free = dict(cfg, frozen_stages=-1)
    assert flops.train_flops(frozen, 512) < flops.train_flops(cfg, 512) \
        < flops.train_flops(free, 512) < 3 * fwd + 1


def test_iou_work_follows_live_candidates_not_the_buffer():
    a = kernels.iou_work([3000] * 8, near=10 ** 6)
    assert a == kernels.iou_work([3000] * 8, near=10 ** 6)
    pairs = 8 * 3000 * 2999 // 2
    assert a[0] == 8 * 3000 * 20 + pairs * 4
    assert a[1] == pairs * 15 + 10 ** 6 * 500
    b = kernels.iou_work([300] * 8, near=10 ** 4)
    assert b[0] < a[0] / 90 and b[1] < a[1] / 90


def test_near_pairs_brute_force():
    g = torch.Generator().manual_seed(1)
    boxes = torch.cat([torch.rand(200, 2, generator=g) * 300,
                       torch.rand(200, 2, generator=g) * 30 + 1,
                       torch.zeros(200, 1)], 1)
    live = 150
    want = 0
    for i in range(live):
        for j in range(i + 1, live):
            d = ((boxes[i, :2] - boxes[j, :2]) ** 2).sum()
            r = (boxes[i, 2:4].norm() + boxes[j, 2:4].norm()) / 2
            want += int(d <= r * r)
    assert kernels.near_pairs(boxes, live) == want


def test_bound_takes_the_larger_share():
    t, by = kernels.bound(3.35e12, 1.0, 'bf16')
    assert by == 'bytes' and t == pytest.approx(1.0)
    t, by = kernels.bound(1.0, 989e12, 'bf16')
    assert by == 'operations' and t == pytest.approx(1.0)
    assert kernels.bound(0, 67e12, 'f32')[0] == pytest.approx(1.0)


def test_stem_work():
    nbytes, ops = kernels.stem_work(8, 1024, 1024)
    assert ops > 2 * 8 * 512 * 512 * 64 * 147
    assert nbytes > 8 * 1024 * 1024 * 3 * 2
    t, by = kernels.bound(nbytes, ops, 'bf16')
    assert by == 'operations' and 3e-5 < t < 5e-5
