"""The K5 kernel's weight pack (``ops/bottleneck_fuse.py::pack_bottleneck``)
and ``Bottleneck``'s pack cache, on the CPU.

The pack is checked by an independent inverse: undoing the swizzle and the
unit order of the stream gives back the BN-folded weights as bf16, or
``_wq``'s codes, exactly; the int8 scales equal those of the plain version
(``fused_bottleneck_q8_reference``). The cache key must change on an
in-place edit of every tensor the pack depends on.
"""
import numpy as np
import pytest
import torch

from r3det_tpu_torch.models.resnet import Bottleneck
from r3det_tpu_torch.ops import bottleneck_fuse as K5

torch.set_num_threads(2)


def folded(f, seed):
    rng = np.random.RandomState(seed)
    c4 = 4 * f
    return [torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))
            for shape, std in (((1, 1, c4, f), c4 ** -0.5), ((f,), 0.1),
                               ((3, 3, f, f), (9 * f) ** -0.5), ((f,), 0.1),
                               ((1, 1, f, c4), f ** -0.5), ((c4,), 0.1))]


def unswizzle(stream, n, k, rows, elem):
    """The (n, k) matrix of one phase from its bytes: units of (rows,
    64-byte chunk), chunks of a row block in order, 16-byte piece c of row r
    stored at c ^ ((r >> 1) & 3)."""
    kb = k * elem // 64
    t = stream.reshape(n // rows, kb, rows, 4, 16)
    r = np.arange(rows)[:, None]
    stored = np.arange(4)[None] ^ ((r >> 1) & 3)
    out = np.empty_like(t)
    out[:, :, r, stored] = t
    return out.transpose(0, 2, 1, 3, 4).reshape(n, k * elem)


def unpack(pack, f):
    """[n][k] bytes of w1 (F, 4F), the nine taps of w2 (F, F), w3 (4F, F):
    conv1's row blocks, then conv2's (each block's nine taps), then
    conv3's."""
    elem = 1 if pack.q8 else 2
    stream = pack.weights.numpy()
    r = min(f, 128)
    off = 0

    def take(n, k, rows):
        nonlocal off
        size = n * k * elem
        m = unswizzle(stream[off:off + size], n, k, rows, elem)
        off += size
        return m

    w1 = take(f, 4 * f, min(f, 128) if pack.q8 else 64)
    blocks = [[take(r, f, r) for _ in range(9)] for _ in range(f // r)]
    w2 = [np.concatenate([b[t] for b in blocks]) for t in range(9)]
    w3 = take(4 * f, f, 128)
    assert off == stream.size
    return [w1] + w2 + [w3]


def as_nk(w1, w2, w3, f):
    """The same weights as [n][k] matrices (output channel, input)."""
    return ([w1.reshape(4 * f, f).t()]
            + [w2[ky, kx].t() for ky in range(3) for kx in range(3)]
            + [w3.reshape(f, 4 * f).t()])


@pytest.mark.parametrize('f', [64, 128, 256])
def test_pack_bf16_unpacks_to_folded_weights(f):
    w1, b1, w2, b2, w3, b3 = folded(f, f)
    pack = K5.pack_bottleneck(w1, b1, w2, b2, w3, b3)
    assert not pack.q8 and pack.features == f
    assert pack.weights.dtype == torch.uint8
    for got, want in zip(unpack(pack, f), as_nk(w1, w2, w3, f)):
        want = want.to(torch.bfloat16).contiguous().view(torch.uint8)
        np.testing.assert_array_equal(got, want.numpy())
    for got, want in zip((pack.b1, pack.b2, pack.b3), (b1, b2, b3)):
        assert torch.equal(got, want)
    assert pack.s1 is None and pack.inv is None


@pytest.mark.parametrize('f', [64, 128, 256])
def test_pack_q8_unpacks_to_codes_and_scales(f):
    w1, b1, w2, b2, w3, b3 = folded(f, f + 1)
    amax = [torch.tensor(5.0), torch.tensor(3.0), torch.tensor(2.5)]
    pack = K5.pack_bottleneck(w1, b1, w2, b2, w3, b3, *amax)
    assert pack.q8 and pack.features == f
    codes, scales = zip(*(K5._wq(w) for w in (w1, w2, w3)))
    for got, want in zip(unpack(pack, f), as_nk(*codes, f)):
        np.testing.assert_array_equal(got.view(np.int8),
                                      want.contiguous().numpy())
    acts = K5._act_scales(*amax)
    for s, a, ks in zip((pack.s1, pack.s2, pack.s3), acts, scales):
        assert torch.equal(s, a * ks)
    assert torch.equal(pack.inv, torch.stack([1.0 / a for a in acts]))


def test_pack_rejects_unsupported_widths():
    with pytest.raises(ValueError):
        K5.pack_bottleneck(*folded(32, 0))


def test_packed_launch_raises_on_cpu_tensors():
    """The kernel's wrapper launches or raises: a CPU input raises."""
    ws = folded(64, 2)
    x = torch.zeros(1, 8, 8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K5.fused_bottleneck_packed(x, K5.pack_bottleneck(*ws))


def block(quantize):
    return Bottleneck(256, 64, quantize=quantize, fused=True).eval()


KEYED = ['conv1.weight', 'conv2.weight', 'conv3.weight', 'bn1.scale',
         'bn1.bias', 'bn1.mean', 'bn1.var', 'bn2.scale', 'bn2.bias',
         'bn2.mean', 'bn2.var', 'bn3.scale', 'bn3.bias', 'bn3.mean',
         'bn3.var']
ABSMAX = ['conv1.act_absmax', 'conv2.act_absmax', 'conv3.act_absmax']


@pytest.mark.parametrize('quantize,name',
                         [(False, n) for n in KEYED]
                         + [('static', n) for n in KEYED + ABSMAX])
def test_pack_key_changes_on_inplace_edit(quantize, name):
    m = block(quantize)
    key = m.fused_pack_key()
    assert m.fused_pack_key() == key
    tensors = dict(m.named_parameters()) | dict(m.named_buffers())
    with torch.no_grad():
        tensors[name].add_(0.5)
    assert m.fused_pack_key() != key


@pytest.mark.parametrize('quantize', [False, 'static'], ids=['bf16', 'q8'])
def test_fused_pack_cached_until_a_weight_changes(quantize):
    m = block(quantize)
    with torch.no_grad():
        m.conv2.weight.normal_()
        for c in (m.conv1, m.conv2, m.conv3):
            if quantize:
                c.act_absmax.fill_(2.0)
    pack = m.fused_pack()
    assert m.fused_pack() is pack
    with torch.no_grad():
        m.conv2.weight.add_(0.5)
    new = m.fused_pack()
    assert new is not pack and not torch.equal(new.weights, pack.weights)
    assert m.fused_pack() is new
