"""LSKNet's attention sub-block through ``ops/lsk_attn.py`` on the CPU,
where every pass runs its plain form.

- The route (``lsk_attn.attention``: norm1 folded into proj_1, the four
  products on the NHWC view, the five passes) equals the eager sub-block
  ``x + layer_scale_1 * Attn(norm1(x))`` in float32 to 1e-5, at widths 16,
  32 and 48 on maps with odd sides and a map smaller than the taps'
  reach; planted faults miss that by far.
- Where a pass's boundaries fall on the eager module's ops, its plain form
  is those ops bit for bit in float32 on channels_last maps (the card's
  layout): the taps are ``conv0`` and ``LSKblock.spatial``, the selection
  is ``LSKblock.select`` and the weighted sum.
- Forced on through a small LSKNet, the route runs inside each block's
  ``backbone.lsk.attn`` span (10 a forward, the four products of each
  inside it) and equals the eager backbone.
- The contracts refuse widths the kernels do not take and NCHW maps
  (float32, CPU tensors, the switch off and gradients are
  ``tests/test_torch_routes.py``'s cases); the public entries take the
  plain forms on the CPU and the wrappers raise; the kept weight pack
  follows the weights.
"""
import types

import pytest
import torch
import torch.nn.functional as F

from r3det_tpu_torch.models import lsknet
from r3det_tpu_torch.ops import lsk_attn as L

from program_spans import traced

torch.set_num_threads(2)
# The route and the eager sub-block make the same float32 operations but
# for norm1 folded into proj_1 and the 1x1 convs taken as matrix products
# (other summation orders): ~2e-7 relative. A branch, a bias or the
# shortcut left out reads 1e-2 or more.
TOL = 1e-5


def seeded_block(c, seed):
    """A block of ``c`` channels whose every parameter shows in the
    sub-block's output: convs normal(0, fan_in**-0.5), biases, BN and layer
    scale drawn wide, BN's running statistics spread."""
    g = torch.Generator().manual_seed(seed)
    block = lsknet.Block(c, 4)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) * p[0].numel() ** -.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5
                        + (1.0 if 'norm1.weight' in name
                           or 'layer_scale' in name else 0.0))
        block.norm1.running_mean.copy_(torch.randn(c, generator=g))
        block.norm1.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return block.to(memory_format=torch.channels_last)


def block_map(b, c, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, c, h, w, generator=g).contiguous(
        memory_format=torch.channels_last)


def eager(block, x):
    return torch.addcmul(x, block.layer_scale_1.view(1, -1, 1, 1),
                         block.attn(block.norm1(x)))


def route(block, x):
    return L.attention(x, block.attn_pack(x.dtype))


def rel(a, b, x):
    """|a - b| over the sub-block's contribution ``b - x``."""
    return float((a - b).norm() / (b - x).norm())


MAPS = {'odd': (13, 11), 'square': (16, 16), 'wide': (5, 23),
        'small': (3, 4)}


@pytest.mark.parametrize('c', [16, 32, 48])
@pytest.mark.parametrize('hw', list(MAPS))
def test_route_equals_the_eager_sub_block(hw, c):
    block = seeded_block(c, seed=c)
    x = block_map(2, c, *MAPS[hw], seed=len(hw))
    with torch.no_grad():
        got, want = route(block, x), eager(block, x)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert rel(got, want, x) < TOL


def eager_parts(block, x):
    """The eager sub-block's intermediates: v, a1, a2, b1, b2, m."""
    sgu = block.attn.spatial_gating_unit
    v = F.gelu(block.attn.proj_1(block.norm1(x)))
    a1 = sgu.conv0(v)
    a2 = sgu.spatial(a1)
    b1, b2 = sgu.conv1(a1), sgu.conv2(a2)
    s = sgu.select(b1, b2)
    return v, a1, a2, b1, b2, torch.addcmul(b1 * s[:, :1], b2, s[:, 1:])


def nhwc(t):
    return t.permute(0, 2, 3, 1)


@pytest.mark.parametrize('c', [16, 48])
def test_taps_plain_form_is_conv0_and_conv_spatial(c):
    block = seeded_block(c, seed=1)
    x = block_map(2, c, 13, 11, seed=2)
    with torch.no_grad():
        v, a1, a2, *_ = eager_parts(block, x)
        p = block.attn_pack(torch.float32)
        got = L.taps_reference(nhwc(v), p.taps, p.b0, p.bs)
    assert got.shape == (2, 13, 11, 2 * c) and got.is_contiguous()
    assert torch.equal(got[..., :c], nhwc(a1))
    assert torch.equal(got[..., c:], nhwc(a2))


@pytest.mark.parametrize('c', [16, 48])
def test_select_plain_form_is_the_eager_selection(c):
    """Handed the products before their biases, the selection adds the
    biases and gives the eager ``b1 * s0 + b2 * s1``."""
    block = seeded_block(c, seed=3)
    x = block_map(2, c, 9, 14, seed=4)
    with torch.no_grad():
        _, _, _, b1, b2, m = eager_parts(block, x)
        p = block.attn_pack(torch.float32)
        raw = nhwc(torch.cat([b1, b2], 1)) - p.b12
        want_b = nhwc(torch.cat([b1, b2], 1))
        assert torch.equal(raw + p.b12, want_b)  # the bias add undoes
        got = L.select_reference(raw, p.b12, p.wq, p.bq)
    assert torch.equal(got, nhwc(m))


def test_pack_folds_norm1_into_proj_1():
    """``W1 diag(inv)`` and ``b1 + W1 shift`` applied to ``x`` give
    ``proj_1(norm1(x))``; the block-diagonal product gives ``conv1(a1)``
    and ``conv2(a2)`` side by side."""
    block = seeded_block(32, seed=5)
    x = block_map(1, 32, 6, 7, seed=6)
    with torch.no_grad():
        p = block.attn_pack(torch.float32)
        want = nhwc(block.attn.proj_1(block.norm1(x)))
        torch.testing.assert_close(F.linear(nhwc(x), p.w1, p.b1), want,
                                   rtol=1e-5, atol=1e-5)
        _, a1, a2, b1, b2, _ = eager_parts(block, x)
        got = F.linear(nhwc(torch.cat([a1, a2], 1)), p.w12, p.b12)
        torch.testing.assert_close(got, nhwc(torch.cat([b1, b2], 1)),
                                   rtol=1e-5, atol=1e-5)


def _taps_dilation_1(v, w, b0, bs):
    c = v.shape[-1]
    a1 = F.conv2d(nhwc_inv(v), w[:25].t().reshape(c, 1, 5, 5), b0,
                  padding=2, groups=c)
    a2 = F.conv2d(a1, w[25:].t().reshape(c, 1, 7, 7), bs, padding=3,
                  groups=c)
    return torch.cat([nhwc(a1), nhwc(a2)], -1)


def nhwc_inv(t):
    return t.permute(0, 3, 1, 2)


def _select_swapped(b, cb, wq, bq):
    return L.select_reference(b, cb, wq.flip(0), bq.flip(0))


def _residual_without_shortcut(a, bias, x, inv, shift, ls):
    return torch.addcmul(x, ls, a + bias)


def _gelu_without_bias(a, bias):
    return F.gelu(a)


FAULTS = {'taps_dilation_1': ('taps', _taps_dilation_1),
          'selection_swapped': ('select', _select_swapped),
          'shortcut_dropped': ('bias_residual', _residual_without_shortcut),
          'proj_1_bias_dropped': ('bias_gelu', _gelu_without_bias)}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_planted_fault_misses_the_tolerance(fault, monkeypatch):
    block = seeded_block(32, seed=7)
    x = block_map(2, 32, 13, 11, seed=8)
    name, fn = FAULTS[fault]
    monkeypatch.setattr(L, name, fn)
    with torch.no_grad():
        assert rel(route(block, x), eager(block, x), x) > 1000 * TOL


def small_lsknet():
    """LSKNet at widths 16-32-48-64, MLP ratio 4 and LSKNet-S's depths,
    seeded as :func:`seeded_block`, channels_last as on the card."""
    net = lsknet.LSKNet(embed_dims=(16, 32, 48, 64), mlp_ratios=(4,) * 4)
    for i, blocks in enumerate((net.block1, net.block2, net.block3,
                                net.block4)):
        for j, block in enumerate(blocks):
            block.load_state_dict(seeded_block(block.norm1.weight.numel(),
                                               10 * i + j).state_dict())
    return net.to(memory_format=torch.channels_last)


def test_route_forced_through_a_whole_backbone_in_its_spans(monkeypatch):
    """On 64 x 72 images (stages of 16 x 18 down to 2 x 3) the route,
    forced on, runs in each of the 10 ``backbone.lsk.attn`` spans, the
    four products of each inside it (40 ``aten::linear`` ranges, none
    outside), and the backbone equals the eager one."""
    net = small_lsknet()
    g = torch.Generator().manual_seed(9)
    x = torch.rand(2, 64, 72, 3, generator=g) * 4 - 2
    calls = []
    real = L.attention

    def counted(*args):
        calls.append(args[0].shape[1])
        return real(*args)
    with torch.no_grad():
        want = net(x)
        monkeypatch.setattr(L, 'refusal', lambda *args: None)
        monkeypatch.setattr(L, 'attention', counted)
        got, spans = traced(lambda: net(x))
    assert calls == [16, 16, 32, 32, 48, 48, 48, 48, 64, 64]
    for a, b in zip(got, want):
        assert float((a - b).norm() / b.norm()) < TOL
    attn = [(s, e) for n, s, e in spans if n == 'r3det.backbone.lsk.attn']
    assert len(attn) == 10
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
    attn = [e.time_range for e in events
            if e.name == 'r3det.backbone.lsk.attn']
    linear = [e.time_range for e in events if e.name == 'aten::linear']
    assert len(attn) == 10 and len(linear) == 40
    assert all(sum(a.start <= t.start and t.end <= a.end for a in attn) == 1
               for t in linear)


def test_block_takes_the_eager_path_on_the_cpu(monkeypatch):
    """Without a forced route a block runs the eager sub-blocks (the
    parent's ops, bit for bit) and never calls either route."""
    from r3det_tpu_torch.ops import lsk_mlp
    block = seeded_block(32, seed=11)
    x = block_map(2, 32, 9, 9, seed=12)
    monkeypatch.setattr(L, 'attention', None)
    monkeypatch.setattr(lsk_mlp, 'mlp', None)
    with torch.no_grad():
        got = block(x)
        want = eager(block, x)
        want = torch.addcmul(want, block.layer_scale_2.view(1, -1, 1, 1),
                             block.mlp(block.norm2(want)))
    assert torch.equal(got, want)


def card_map(shape, dtype=torch.bfloat16, channels_last=True):
    """What a contract reads of a map on a card."""
    return types.SimpleNamespace(
        shape=shape, dtype=dtype, is_cuda=True, requires_grad=False,
        device=torch.device('cuda'),
        is_contiguous=lambda memory_format=None: channels_last)


CONTRACTS = {'sub_block': L.refusal, 'taps': L.taps_refusal,
             'select': L.select_refusal, 'epilogue': L.epilogue_refusal}


@pytest.mark.parametrize('contract,shape,reason', [
    ('sub_block', (2, 40, 8, 8), 'C % 16'),
    ('taps', (2, 8, 8, 36), 'C % 8'),
    ('select', (2, 8, 8, 40), 'C % 16'),
    ('epilogue', (2, 8, 8, 36), 'C % 8')])
def test_contract_refuses_widths(contract, shape, reason):
    """What each contract refuses beyond ``tests/test_torch_routes.py``'s
    dtype, device, switch and gradient cases: widths."""
    assert reason in CONTRACTS[contract](card_map(shape))


def test_sub_block_contract_refuses_nchw_maps():
    assert 'channels_last' in L.refusal(card_map((2, 64, 8, 8),
                                                 channels_last=False))


def _inputs(c=32, seed=13):
    """bf16 CPU arguments of each public entry: {name: args}."""
    block = seeded_block(c, seed)
    x = block_map(2, c, 7, 9, seed=seed).bfloat16()
    with torch.no_grad():
        p = block.attn_pack(torch.bfloat16)
    xh = nhwc(x)
    g = torch.Generator().manual_seed(seed)

    def rnd(k):
        return torch.randn(2, 7, 9, k, generator=g).bfloat16()
    return {'taps': (xh, p.taps, p.b0, p.bs),
            'select': (rnd(c), p.b12, p.wq, p.bq),
            'bias_gelu': (rnd(c), p.b1),
            'bias_gate': (rnd(c), p.b3, xh),
            'bias_residual': (rnd(c), p.b2, xh, p.inv, p.shift, p.ls)}


@pytest.mark.parametrize('name', ['taps', 'select', 'bias_gelu',
                                  'bias_gate', 'bias_residual'])
def test_public_entry_takes_the_plain_form_on_the_cpu(name):
    args = _inputs()[name]
    with torch.no_grad():
        got = getattr(L, name)(*[t.clone() for t in args])
        want = getattr(L, f'{name}_reference')(*args)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match='CUDA'):
            getattr(L, f'{name}_cuda')(*args)
        with pytest.raises(ValueError, match='float32'):
            getattr(L, f'{name}_cuda')(*[t.float() for t in args])


def test_pack_is_kept_and_follows_the_weights():
    """Without autograd the pack is kept until a parameter or a buffer
    changes; with autograd it is built anew, on the autograd graph."""
    block = seeded_block(32, seed=14)
    with torch.no_grad():
        first = block.attn_pack(torch.bfloat16)
        assert block.attn_pack(torch.bfloat16) is first
        block.attn.proj_2.bias.add_(1.0)
        moved = block.attn_pack(torch.bfloat16)
        assert moved is not first
        assert torch.equal(moved.b2, block.attn.proj_2.bias.bfloat16())
        block.norm1.running_var.mul_(4.0)
        assert block.attn_pack(torch.bfloat16) is not moved
    assert block.attn_pack(torch.bfloat16).w1.requires_grad


@pytest.mark.parametrize('shape,tile', [((8, 256, 256), 32),
                                        ((8, 128, 128), 16),
                                        ((8, 64, 64), 8), ((8, 32, 32), 8),
                                        ((1, 13, 11), 8)])
def test_select_tile_gives_two_blocks_an_sm(shape, tile):
    assert L.select_tile(*shape, 132) == tile


def test_kernel_bounds_at_stage_one():
    """The bounds ``chip_smoke.py`` prints beside the kernels at LSKNet-S's
    stage 1 (batch 8 of 1024^2: 256^2 positions of 64 channels): the taps
    do 150 float32 operations a channel and position (0.075 ms at 67
    TFLOP/s), the others move their bytes at 3.35 TB/s."""
    from r3det_tpu_torch.utils.kernel_timing import lsk_attn_work
    work = lsk_attn_work(8, 256, 256, 64)
    n = 8 * 256 * 256
    taps_ms, taps_by = work['lsk_taps']
    assert taps_by == 'operations'
    assert abs(taps_ms - n * 64 * 150 / 67e9) < 1e-6
    for name, maps in (('lsk_select', 1.5), ('lsk_bias_gelu', 2),
                       ('lsk_bias_gate', 3), ('lsk_bias_residual', 3)):
        ms, by = work[name]
        assert by == 'bytes'
        assert abs(ms - 2 * n * 64 * maps / 3.35e9) < 1e-5
