"""Swin's window-attention sub-block through ``ops/swin_attn.py`` on the
CPU, where the route runs the kernels' plain forms.

- ``ShiftWindowMSA.kernel_forward`` (``norm1`` and the pad in one step,
  the qkv product over the padded map, the windows' attention gathered
  through the shift and scattered back with the crop, the proj product)
  plus the residual equals the module's eager path (``norm1``,
  ``ShiftWindowMSA``, the residual) in float32 to 1e-5, on maps padded on
  one axis, on both and on neither, shifted and not, at 3 and 6 heads of
  32 channels, batch 2; this checks the addressing the CUDA kernels
  repeat (shift, pad, windows, region mask, crop, bias index) where the
  CPU tests can see it.
- Planted faults in that addressing miss the tolerance by far.
- The route, forced on, through a whole small backbone equals the eager
  backbone.
- The contracts and the wrappers refuse what the kernels do not take: a
  CPU tensor, float32, head_dim other than 32, window 12.
"""
import types

import pytest
import torch

from r3det_tpu_torch.models import swin
from r3det_tpu_torch.ops import swin_attn as A

torch.set_num_threads(2)
# The two routes make the same float32 operations but for the order of a
# few sums and where the q scale is applied: ~1e-7 relative an op.
TOL = dict(rtol=1e-5, atol=1e-5)
WINDOW = 7


def seeded_block(heads, shift, seed):
    """A Swin block of ``heads`` x 32 channels whose weights are drawn
    wide enough that each part of the attention shows in its output: the
    bias table normal(0, 1), the linears normal(0, fan_in**-0.5), the
    norm's gain and shift normal."""
    dims = heads * A.HEAD_DIM
    g = torch.Generator().manual_seed(seed)
    block = swin.SwinBlock(dims, heads, 4 * dims, WINDOW, shift)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith('relative_position_bias_table'):
                p.copy_(torch.randn(p.shape, generator=g))
            elif p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g) * p.shape[1] ** -.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5
                        + (1.0 if name.endswith('weight') else 0.0))
    return block


def block_input(b, h, w, c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, h, w, c, generator=g)


def both_routes(block, x):
    with torch.no_grad():
        eager = x + block.attn(block.norm1(x))
        route = x + block.attn.kernel_forward(x, block.norm1)
    return route, eager


MAPS = {'pad_h': (17, 14), 'pad_w': (14, 19), 'pad_both': (15, 17),
        'no_pad': (14, 21)}


@pytest.mark.parametrize('heads', [3, 6])
@pytest.mark.parametrize('shift', [False, True], ids=['plain', 'shifted'])
@pytest.mark.parametrize('hw', list(MAPS), ids=list(MAPS))
def test_route_equals_the_eager_sub_block(hw, shift, heads):
    h, w = MAPS[hw]
    block = seeded_block(heads, shift, seed=heads)
    x = block_input(2, h, w, heads * A.HEAD_DIM, seed=h * w)
    route, eager = both_routes(block, x)
    assert route.shape == (2, h, w, heads * A.HEAD_DIM)
    torch.testing.assert_close(route, eager, **TOL)


def test_norm_pad_writes_zeros_in_the_pad():
    block = seeded_block(3, False, seed=0)
    x = block_input(2, 9, 11, 96, seed=1)
    n = block.norm1
    y = A.norm_pad(x, n.weight, n.bias, n.eps, 14, 14)
    assert y.shape == (2, 14, 14, 96)
    assert not y[:, 9:].any() and not y[:, :, 11:].any()
    torch.testing.assert_close(y[:, :9, :11], n(x), rtol=0, atol=0)


def test_window_places_cover_the_map_once():
    """Every padded-map place appears in exactly one window, shifted or
    not; shifted, the first window starts at (shift, shift)."""
    for shift in (0, 3):
        place, region = A.window_places(21, 14, WINDOW, shift,
                                        torch.device('cpu'))
        assert place.shape == (6, 49)
        assert torch.equal(place.reshape(-1).sort().values,
                           torch.arange(21 * 14))
        assert int(place[0, 0]) == shift * 14 + shift
    assert int(region.max()) == 8 and not region[0].any()


def test_bias_index_is_the_modules_buffer():
    for window in (2, 7, 8):
        assert torch.equal(A.bias_index(window, torch.device('cpu')),
                           swin.relative_position_index(window))


def _no_shift(qkv, table, heads, window, shift, h, w):
    return A.window_attn_reference(qkv, table, heads, window, 0, h, w)


def _shift_backwards(qkv, table, heads, window, shift, h, w):
    """The roll's sign flipped: windows gathered from (y - s, x - s)."""
    rolled = torch.roll(qkv, (2 * shift, 2 * shift), (1, 2))
    return A.window_attn_reference(rolled, table, heads, window, shift, h, w)


def _no_mask(qkv, table, heads, window, shift, h, w):
    real = A.window_places

    def unmasked(*args):
        place, region = real(*args)
        return place, torch.zeros_like(region)
    A.window_places = unmasked
    try:
        return A.window_attn_reference(qkv, table, heads, window, shift, h, w)
    finally:
        A.window_places = real


def _index_transposed(qkv, table, heads, window, shift, h, w):
    real = A.bias_index
    A.bias_index = lambda *a: real(*a).T
    try:
        return A.window_attn_reference(qkv, table, heads, window, shift, h, w)
    finally:
        A.bias_index = real


FAULTS = {'shift_dropped': _no_shift, 'roll_sign_flipped': _shift_backwards,
          'mask_dropped': _no_mask, 'index_transposed': _index_transposed}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_planted_fault_misses_the_tolerance(fault, monkeypatch):
    block = seeded_block(3, True, seed=3)
    x = block_input(2, 15, 17, 96, seed=4)
    monkeypatch.setattr(A, 'window_attn', FAULTS[fault])
    route, eager = both_routes(block, x)
    err = float((route - eager).norm() / (eager - x).norm())
    assert err > 1000 * TOL['rtol']


def test_route_forced_through_a_whole_backbone(monkeypatch):
    """A small Swin (embed 32, heads 1-2-4-8, window 7) on 100 x 100
    images: stages of 25, 13, 7 and 4 tokens a side, the last smaller
    than its window. The route forced on equals the eager backbone."""
    torch.manual_seed(0)
    net = swin.SwinTransformer(embed_dims=32, depths=(2, 2, 2, 2),
                               num_heads=(1, 2, 4, 8), out_indices=(1, 2, 3))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('relative_position_bias_table'):
                p.normal_()
    x = torch.rand(2, 100, 100, 3) * 4 - 2
    with torch.no_grad():
        want = net(x)
        calls = []
        real = swin.ShiftWindowMSA.kernel_forward

        def counted(self, *args):
            calls.append(self.shift)
            return real(self, *args)
        monkeypatch.setattr(A, 'refusal', lambda *args: None)
        monkeypatch.setattr(swin.ShiftWindowMSA, 'kernel_forward', counted)
        got = net(x)
    assert calls == [0, 3] * 4
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **TOL)


def card_map(dims, dtype=torch.bfloat16):
    """What the sub-block's contract reads of a (1, 7, 7, dims) map on a
    card."""
    return types.SimpleNamespace(shape=(1, 7, 7, dims), dtype=dtype,
                                 is_cuda=True, requires_grad=False,
                                 device=torch.device('cuda'))


def test_route_predicate_refuses():
    """On the CPU no block takes the route; the reasons a card would
    refuse: float32, head_dim 16, window 12, and a width the norm kernel
    does not hold (Swin-B's stage 4, C 1024, and Swin-L's, C 1536, both at
    head_dim 32)."""
    block = seeded_block(3, True, seed=0)
    x = block_input(1, 7, 7, 96, seed=0).bfloat16()
    with torch.no_grad():
        assert 'CUDA' in A.refusal(x, 3, block.attn.window)
        assert A.refusal(card_map(96), 3, 7) is None
        assert A.refusal(card_map(96), 3, 8) is None
        assert 'bfloat16' in A.refusal(card_map(96, torch.float32), 3, 7)
        assert 'head_dim' in A.refusal(card_map(96), 6, 7)
        assert 'window' in A.refusal(card_map(96), 3, 12)
        assert A.refusal(card_map(768), 24, 7) is None
        assert 'C a multiple' in A.refusal(card_map(1024), 32, 7)
        assert 'C a multiple' in A.refusal(card_map(1536), 48, 7)


@pytest.mark.parametrize('case,reason', [
    ('cpu', 'CUDA'), ('float32', 'bfloat16'), ('head_dim_16', 'head_dim'),
    ('window_12', 'window')])
def test_wrappers_refuse(case, reason):
    heads, window, dtype = 3, 7, torch.bfloat16
    if case == 'float32':
        dtype = torch.float32
    if case == 'head_dim_16':
        heads = 6
    if case == 'window_12':
        window = 12
    hp = 2 * window
    qkv = torch.zeros(1, hp, hp, 3 * 96, dtype=dtype)
    table = torch.zeros((2 * window - 1) ** 2, heads)
    with pytest.raises(ValueError, match=reason):
        A.window_attn_cuda(qkv, table, heads, window, 0, hp - 1, hp - 1)
    if case in ('cpu', 'float32'):
        x = torch.zeros(1, 5, 5, 96, dtype=dtype)
        with pytest.raises(ValueError, match=reason):
            A.norm_pad_cuda(x, torch.ones(96), torch.zeros(96), 1e-5, 7, 7)


def test_kernel_bounds_at_stage_one():
    """The bounds ``tools/kernel_bench.py swin`` prints beside the kernels,
    at Swin-T's stage 1 (batch 8 of 1024^2: 256^2 tokens of 96 channels,
    259^2 padded): the norm moves 204 MB, the attention 410 MB, both bound
    by bytes at 3.35 TB/s."""
    from r3det_tpu_torch.utils.kernel_timing import swin_attn_work
    work = swin_attn_work(8, 256, 256, 96, 3, WINDOW)
    norm_ms, norm_by = work['swin_norm_pad']
    attn_ms, attn_by = work['swin_window_attn']
    assert norm_by == attn_by == 'bytes'
    assert abs(norm_ms - 2 * 8 * (256 ** 2 + 259 ** 2) * 96 / 3.35e9) < 1e-3
    assert abs(attn_ms - 2 * 8 * (3 * 259 ** 2 + 256 ** 2) * 96 / 3.35e9) \
        < 1e-3
    assert set(work) == {'swin_norm_pad', 'swin_window_attn'}
