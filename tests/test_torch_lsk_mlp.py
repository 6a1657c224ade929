"""LSKNet's MLP sub-block through ``ops/lsk_mlp.py`` on the CPU, where both
passes run their plain forms.

- The route (``lsk_mlp.mlp``: norm2 folded into fc1, the two products on
  the NHWC view, ``dw_gelu`` and ``bias_scale``) equals the eager
  sub-block ``x + layer_scale_2 * MLP(norm2(x))`` in float32 to 1e-5, at
  each of LSKNet-S's stage widths (64, 128, 320, 512 with MLP ratios 8, 8,
  4, 4) on a map with odd sides and one of 2 x 3, where every output
  reads the padding; planted faults miss that by far, among them fc1's
  bias added to the padding too.
- Where a pass's boundaries fall on the eager module's ops, its plain form
  is those ops bit for bit in float32 on channels_last maps.
- Forced on through a small LSKNet, the route runs inside each block's
  ``backbone.lsk.mlp`` span (10 a forward, its two products inside it) and
  equals the eager backbone.
- The contracts refuse widths the kernels do not take and NCHW maps
  (float32, CPU tensors, the switch off and gradients are
  ``tests/test_torch_routes.py``'s cases); the public entries take the
  plain forms on the CPU and the wrappers raise; the kept weight pack
  follows the weights; the tile rows and the bounds.
"""
import types

import pytest
import torch
import torch.nn.functional as F

from r3det_tpu_torch.models import lsknet
from r3det_tpu_torch.ops import lsk_mlp as M

from program_spans import traced

torch.set_num_threads(2)
# The route and the eager sub-block make the same float32 operations but
# for norm2 folded into fc1 and the 1x1 convs taken as matrix products
# (other summation orders): ~2e-7 relative. A bias, the pad or the layer
# scale wrong reads 1e-3 or more.
TOL = 1e-5
# LSKNet-S's stages: width, MLP ratio
STAGES = {'s1': (64, 8), 's2': (128, 8), 's3': (320, 4), 's4': (512, 4)}


def seeded_block(c, ratio, seed):
    """A block of ``c`` channels whose every MLP parameter shows in the
    sub-block's output: convs normal(0, fan_in**-0.5), biases, BN and layer
    scale drawn wide, norm2's running statistics spread."""
    g = torch.Generator().manual_seed(seed)
    block = lsknet.Block(c, ratio)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g)
                        * p[0].numel() ** -.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5
                        + (1.0 if 'norm2.weight' in name
                           or 'layer_scale' in name else 0.0))
        block.norm2.running_mean.copy_(torch.randn(c, generator=g))
        block.norm2.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return block.to(memory_format=torch.channels_last)


def block_map(b, c, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, c, h, w, generator=g).contiguous(
        memory_format=torch.channels_last)


def eager(block, x):
    return torch.addcmul(x, block.layer_scale_2.view(1, -1, 1, 1),
                         block.mlp(block.norm2(x)))


def route(block, x):
    return M.mlp(x, block.mlp_pack(x.dtype))


def rel(a, b, x):
    """|a - b| over the sub-block's contribution ``b - x``."""
    return float((a - b).norm() / (b - x).norm())


def nhwc(t):
    return t.permute(0, 2, 3, 1)


MAPS = {'odd': (13, 11), 'small': (2, 3)}


@pytest.mark.parametrize('stage', list(STAGES))
@pytest.mark.parametrize('hw', list(MAPS))
def test_route_equals_the_eager_sub_block(hw, stage):
    c, ratio = STAGES[stage]
    block = seeded_block(c, ratio, seed=c)
    x = block_map(1, c, *MAPS[hw], seed=len(hw))
    with torch.no_grad():
        got, want = route(block, x), eager(block, x)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert rel(got, want, x) < TOL


def test_dw_gelu_plain_form_is_dwconv_and_gelu():
    """Handed fc1's output and a zero bias, the plain form is the eager
    ``GELU(dwconv(.))`` bit for bit."""
    block = seeded_block(32, 4, seed=1)
    x = block_map(2, 32, 13, 11, seed=2)
    with torch.no_grad():
        f = block.mlp.fc1(block.norm2(x))
        want = F.gelu(block.mlp.dwconv(f))
        p = block.mlp_pack(torch.float32)
        got = M.dw_gelu_reference(nhwc(f), torch.zeros_like(p.b1), p.taps,
                                  p.bd)
    assert got.shape == (2, 13, 11, 128) and got.is_contiguous()
    assert torch.equal(got, nhwc(want))


def test_bias_scale_plain_form_is_the_eager_residual():
    block = seeded_block(32, 4, seed=3)
    x = block_map(2, 32, 9, 14, seed=4)
    with torch.no_grad():
        m = block.mlp(block.norm2(x))
        p = block.mlp_pack(torch.float32)
        got = M.bias_scale_reference(nhwc(m), torch.zeros_like(p.b2),
                                     nhwc(x), p.ls)
    assert torch.equal(got, nhwc(eager(block, x)))


def test_pack_folds_norm2_into_fc1():
    """``W1 diag(inv)`` and ``b1 + W1 shift`` applied to ``x`` give
    ``fc1(norm2(x))``; the taps are dwconv's, row-major."""
    block = seeded_block(32, 4, seed=5)
    x = block_map(1, 32, 6, 7, seed=6)
    with torch.no_grad():
        p = block.mlp_pack(torch.float32)
        want = nhwc(block.mlp.fc1(block.norm2(x)))
        torch.testing.assert_close(F.linear(nhwc(x), p.w1, p.b1), want,
                                   rtol=1e-5, atol=1e-5)
    w = block.mlp.dwconv.dwconv.weight
    assert p.taps.shape == (9, 128) and p.taps.is_contiguous()
    assert torch.equal(p.taps[4], w[:, 0, 1, 1])
    assert torch.equal(p.taps[2], w[:, 0, 0, 2])


def _dw_gelu_bias_on_the_padding(h, b1, w, bd):
    """fc1's bias added after the pad: the padding reads b1, not 0."""
    c = h.shape[-1]
    hb = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1)) + b1.view(1, -1, 1, 1)
    d = F.conv2d(hb, w.t().reshape(c, 1, 3, 3), bd, groups=c)
    return F.gelu(d).permute(0, 2, 3, 1)


def _dw_gelu_without_dw_bias(h, b1, w, bd):
    return M.dw_gelu_reference(h, b1, w, torch.zeros_like(bd))


def _bias_scale_without_layer_scale(a, bias, x, ls):
    return x + (a + bias)


def _bias_scale_without_bias(a, bias, x, ls):
    return torch.addcmul(x, ls, a)


FAULTS = {'fc1_bias_on_the_padding': ('dw_gelu',
                                      _dw_gelu_bias_on_the_padding),
          'dwconv_bias_dropped': ('dw_gelu', _dw_gelu_without_dw_bias),
          'layer_scale_dropped': ('bias_scale',
                                  _bias_scale_without_layer_scale),
          'fc2_bias_dropped': ('bias_scale', _bias_scale_without_bias)}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_planted_fault_misses_the_tolerance(fault, monkeypatch):
    """On a 2 x 3 map every output reads the padding, so fc1's bias on it
    shows as much as any other fault."""
    block = seeded_block(32, 4, seed=7)
    x = block_map(2, 32, 2, 3, seed=8)
    name, fn = FAULTS[fault]
    monkeypatch.setattr(M, name, fn)
    with torch.no_grad():
        assert rel(route(block, x), eager(block, x), x) > 100 * TOL


def small_lsknet():
    """LSKNet at widths 16-32-48-64, MLP ratio 4 and LSKNet-S's depths,
    seeded as :func:`seeded_block`, channels_last as on the card."""
    net = lsknet.LSKNet(embed_dims=(16, 32, 48, 64), mlp_ratios=(4,) * 4)
    for i, blocks in enumerate((net.block1, net.block2, net.block3,
                                net.block4)):
        for j, block in enumerate(blocks):
            block.load_state_dict(seeded_block(
                block.norm2.weight.numel(), 4, 10 * i + j).state_dict())
    return net.to(memory_format=torch.channels_last)


def test_route_forced_through_a_whole_backbone_in_its_spans(monkeypatch):
    """On 64 x 72 images (stages of 16 x 18 down to 2 x 3) the route,
    forced on, runs in each of the 10 ``backbone.lsk.mlp`` spans, its two
    products inside it (20 ``aten::linear`` ranges, none outside), and the
    backbone equals the eager one."""
    net = small_lsknet()
    g = torch.Generator().manual_seed(9)
    x = torch.rand(2, 64, 72, 3, generator=g) * 4 - 2
    calls = []
    real = M.mlp

    def counted(*args):
        calls.append(args[0].shape[1])
        return real(*args)
    with torch.no_grad():
        want = net(x)
        monkeypatch.setattr(M, 'refusal', lambda *args: None)
        monkeypatch.setattr(M, 'mlp', counted)
        got, spans = traced(lambda: net(x))
    assert calls == [16, 16, 32, 32, 48, 48, 48, 48, 64, 64]
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < TOL
    assert sum(n == 'r3det.backbone.lsk.mlp' for n, _, _ in spans) == 10
    with torch.no_grad():
        from torch.profiler import ProfilerActivity, profile
        from r3det_tpu_torch.utils import tracing
        tracing.enable(True)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                net(x)
        finally:
            tracing.enable(False)
    events = prof.events()
    mlp = [e.time_range for e in events if e.name == 'r3det.backbone.lsk.mlp']
    linear = [e.time_range for e in events if e.name == 'aten::linear']
    assert len(mlp) == 10 and len(linear) == 20
    assert all(sum(a.start <= t.start and t.end <= a.end for a in mlp) == 1
               for t in linear)


def card_map(shape, dtype=torch.bfloat16, channels_last=True):
    """What a contract reads of a map on a card."""
    return types.SimpleNamespace(
        shape=shape, dtype=dtype, is_cuda=True, requires_grad=False,
        device=torch.device('cuda'),
        is_contiguous=lambda memory_format=None: channels_last)


@pytest.mark.parametrize('shape,hidden,reason', [
    ((2, 36, 8, 8), 144, 'C and hidden % 8'),
    ((2, 40, 8, 8), 100, 'C and hidden % 8')])
def test_sub_block_contract_refuses_widths(shape, hidden, reason):
    """What the contracts refuse beyond ``tests/test_torch_routes.py``'s
    dtype, device, switch and gradient cases: widths, and NCHW maps."""
    assert reason in M.refusal(card_map(shape), hidden)
    assert M.refusal(card_map((2, 40, 8, 8)), 160) is None


def test_dw_gelu_contract_refuses_widths_and_nchw_maps():
    assert 'C % 8' in M.dw_gelu_refusal(card_map((2, 8, 8, 36)))
    assert 'channels_last' in M.refusal(card_map((2, 64, 8, 8),
                                                 channels_last=False), 256)


def _inputs(c=32, seed=13):
    """bf16 CPU arguments of each public entry: {name: args}."""
    block = seeded_block(c, 4, seed)
    x = block_map(2, c, 7, 9, seed=seed).bfloat16()
    with torch.no_grad():
        p = block.mlp_pack(torch.bfloat16)
    g = torch.Generator().manual_seed(seed)

    def rnd(k):
        return torch.randn(2, 7, 9, k, generator=g).bfloat16()
    return {'dw_gelu': (rnd(4 * c), p.b1, p.taps, p.bd),
            'bias_scale': (rnd(c), p.b2, nhwc(x), p.ls)}


@pytest.mark.parametrize('name', ['dw_gelu', 'bias_scale'])
def test_public_entry_takes_the_plain_form_on_the_cpu(name):
    args = _inputs()[name]
    with torch.no_grad():
        got = getattr(M, name)(*[t.clone() for t in args])
        want = getattr(M, f'{name}_reference')(*args)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match='CUDA'):
            getattr(M, f'{name}_cuda')(*args)
        with pytest.raises(ValueError, match='float32'):
            getattr(M, f'{name}_cuda')(*[t.float() for t in args])


def test_pack_is_kept_and_follows_the_weights():
    """Without autograd the pack is kept until a parameter or a buffer
    changes, apart from the attention's; with autograd it is built anew,
    on the autograd graph."""
    block = seeded_block(32, 4, seed=14)
    with torch.no_grad():
        first = block.mlp_pack(torch.bfloat16)
        attn = block.attn_pack(torch.bfloat16)
        assert block.mlp_pack(torch.bfloat16) is first
        block.mlp.fc2.bias.add_(1.0)
        moved = block.mlp_pack(torch.bfloat16)
        assert moved is not first
        assert torch.equal(moved.b2, block.mlp.fc2.bias.bfloat16())
        assert block.attn_pack(torch.bfloat16) is attn
        block.norm2.running_var.mul_(4.0)
        again = block.mlp_pack(torch.bfloat16)
        assert again is not moved
        block.mlp.dwconv.dwconv.weight.mul_(2.0)
        latest = block.mlp_pack(torch.bfloat16)
        assert torch.equal(latest.taps, 2 * again.taps)
        block.attn.proj_2.bias.add_(1.0)
        assert block.mlp_pack(torch.bfloat16) is latest
        assert block.attn_pack(torch.bfloat16) is not attn
    assert block.mlp_pack(torch.bfloat16).w1.requires_grad


@pytest.mark.parametrize('shape,rows', [((8, 256, 256, 512), 16),
                                        ((8, 32, 32, 2048), 16),
                                        ((1, 32, 32, 512), 4),
                                        ((8, 32, 32, 1024), 8),
                                        ((1, 13, 11, 128), 4)])
def test_dw_tile_gives_each_block_two_tiles(shape, rows):
    assert M.dw_tile(*shape, 132) == rows


def test_kernel_bounds_at_stage_one():
    """The bounds ``chip_smoke.py`` prints beside the MLP kernels at
    LSKNet-S's stage 1 (batch 8 of 1024^2: 256^2 positions of 64 channels,
    512 hidden): both move their bytes at 3.35 TB/s, the hidden map read
    and written once, fc2's product and x read and the output written."""
    from r3det_tpu_torch.utils.kernel_timing import lsk_mlp_work
    work = lsk_mlp_work(8, 256, 256, 64, 512)
    n = 8 * 256 * 256
    for name, nbytes in (('lsk_dw_gelu', 2 * n * 2 * 512 + 42 * 512),
                         ('lsk_bias_scale', 2 * n * 3 * 64 + 4 * 64)):
        ms, by = work[name]
        assert by == 'bytes'
        assert abs(ms - nbytes / 3.35e9) < 1e-6

