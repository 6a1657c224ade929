"""On-card A/B of the serving kernels against their plain PyTorch forms.

    python -m r3det_tpu_torch.tools.kernel_bench [stem|bottleneck|frm|swin|all]

Port of ``tools/analysis_tools/kernel_bench.py``, with its subcommands,
shapes and batch (32): parity first, max |diff| at batch 1 (one
``parity[...]`` line each), then each variant's milliseconds a call
(CUDA events after warm-up) beside the bound of its function (the larger
of its bytes over the memory rate and its operations over the peak rate,
``utils/kernel_timing.py``) and what sets it.

- ``stem``: the s2d stem of a (32, 1024, 1024, 3) image, a (32, 512, 512,
  12) bf16 input and a (4, 4, 12, 64) kernel: the plain stem with the
  plain pool, the plain conv with K4, K3 bf16 and K3 int8, on weights
  packed once (``ops/stem_pool.py``);
- ``bottleneck``: C2 (256^2, 256 -> 64) and C3 (128^2, 512 -> 128)
  identity blocks: the plain bf16 three-conv form, K5, the plain int8
  form and K5 q8 (``ops/bottleneck_fuse.py``), whose call packs the
  weights; at C2, the bf16 ``Bottleneck`` module on its unfused route and
  on its conv epilogue route, and the conv epilogue kernel alone at conv3's
  output with the identity residual (``ops/conv_epilogue.py``) beside the
  unfused PyTorch passes it replaces, with its share of its bytes bound;
- ``frm``: a (32, 128, 128, 256) bf16 map sampled within +-1.5 px of each
  cell: the plain gather against K2 (``ops/frm_sample.py``). K2 takes
  rois: their ``sample_coords`` (the transposed quirk included) give the
  points, and ``x`` is zero, so both compute ``feat + sample``;
- ``swin``: Swin-T's four stage shapes at batch 8 (the serving batch) of
  1024^2: (256^2, 96, 3 heads), (128^2, 192, 6), (64^2, 384, 12), (32^2,
  768, 24), window 7, a shifted block: ``swin_norm_pad`` and
  ``swin_window_attn`` against their plain forms
  (``ops/swin_attn.py``), ``F.scaled_dot_product_attention`` on the same
  windows as the library's time (the port never calls it), and the whole
  sub-block (``norm1`` through the residual add) on its eager route and
  on the kernels' route, timed with no bound (its yardstick is
  ``swin_attn_roofline``'s, ``portbench/work/swin.py``).

Inputs come from a seeded generator on the card (the JAX tool draws the
same distributions with numpy). There is no CPU fallback: without a card
it exits non-zero.
"""
import argparse
import sys

from ..utils.kernel_timing import bound, cuda_ms, epilogue_bytes

BATCH = 32
DEV = 'cuda'
SEED = 0
ITERS = 10
PLAIN_ITERS = 3


def _gen():
    import torch
    return torch.Generator(DEV).manual_seed(SEED)


def _uniform(gen, shape, lo, hi):
    import torch
    return torch.rand(shape, generator=gen, device=DEV) * (hi - lo) + lo


def _normal(gen, shape, std):
    import torch
    return torch.randn(shape, generator=gen, device=DEV) * std


def _parity(a, b, where, out):
    d = float((a.float() - b.float()).abs().max())
    print(f'  parity[{where}] max|diff| = {d:.6f}', flush=True)
    out[where] = d
    return d


def _ulps(got, want):
    """The largest |got - want| in bf16 ulps of max(|got|, |want|), over
    the values of at least 2^-8 in either (below that a difference is
    under 2^-8, whatever its ulps)."""
    import torch
    big = torch.maximum(got.float().abs(), want.float().abs())
    _, e = torch.frexp(big)
    ulps = (got.float() - want.float()).abs() / torch.ldexp(
        torch.ones_like(big), e - 8)
    return float(torch.where(big >= 2.0 ** -8, ulps,
                             torch.zeros_like(ulps)).max())


def _time(variants, batch, bound_of, tag=''):
    ms = {}
    for name, fn, plain in variants:
        t = cuda_ms(fn, PLAIN_ITERS if plain else ITERS)
        bound = bound_of(name)
        if bound is None:
            print(f'  {tag}{name:26s} b{batch}: {t:8.4f} ms', flush=True)
            ms[name] = dict(ms=t)
            continue
        b_ms, by = bound
        print(f'  {tag}{name:26s} b{batch}: {t:8.4f} ms   bound '
              f'{b_ms:.4f} ms ({by})', flush=True)
        ms[name] = dict(ms=t, bound_ms=b_ms, bound_by=by)
    return ms


def run_stem(batch=BATCH):
    """The stem variants; returns {'parity': {..}, 'ulps': {..}, 'ms':
    {variant: {'ms', 'bound_ms', 'bound_by'}}}."""
    import torch

    from ..ops import stem_pool as sp
    gen = _gen()
    x = _uniform(gen, (batch, 512, 512, 12), -2, 2).to(torch.bfloat16)
    k = _normal(gen, (4, 4, 12, 64), 0.1)
    scale = _uniform(gen, (64,), 0.5, 1.5)
    bias = _uniform(gen, (64,), -0.5, 0.5)
    pack = sp.pack_stem(k, scale, bias)
    pack_q8 = sp.pack_stem(k, scale, bias, quantize=True)
    res = {'parity': {}, 'ulps': {}}
    xs = x[:1]
    with torch.no_grad():
        got = sp.stem_conv_pool_cuda(xs, pack)
        want = sp.stem_conv_pool_reference(xs, k, scale, bias)
        _parity(got, want, 'K3 bf16 vs plain (b1)', res['parity'])
        res['ulps']['K3 bf16 vs plain (b1)'] = _ulps(got, want)
        _parity(sp.stem_conv_pool_cuda(xs, pack_q8),
                sp.stem_conv_pool_q8_reference(xs, k, scale, bias),
                'K3 int8 vs plain int8 (b1)', res['parity'])
        _parity(sp.stem_conv_pool_unfused(xs, k, scale, bias,
                                          pool_kernel=True),
                sp.stem_conv_pool_unfused(xs, k, scale, bias),
                'plain conv + K4 vs plain (b1)', res['parity'])
    ops = 2 * batch * 512 * 512 * 192 * 64      # the folded 4x4x12 conv
    nbytes = x.numel() * 2 + k.numel() * 4 + batch * 256 * 256 * 64 * 2

    def bound_of(name):
        return bound(nbytes, ops, 'int8' if 'int8' in name else 'bf16')
    with torch.no_grad():
        res['ms'] = _time([
            ('plain stem + plain pool', lambda: sp.stem_conv_pool_unfused(
                x, k, scale, bias), True),
            ('plain conv + K4', lambda: sp.stem_conv_pool_unfused(
                x, k, scale, bias, pool_kernel=True), True),
            ('K3 bf16', lambda: sp.stem_conv_pool_cuda(x, pack), False),
            ('K3 int8', lambda: sp.stem_conv_pool_cuda(x, pack_q8), False),
        ], batch, bound_of)
    return res


BOTTLENECKS = ((256, 256, 256, 64, 'C2'), (128, 128, 512, 128, 'C3'))


def run_bottleneck(batch=BATCH):
    """The identity-block variants at C2 and C3; returns {'parity': {..},
    'ms': {tag: {variant: {..}}}}."""
    import torch

    from ..ops import bottleneck_fuse as bf
    gen = _gen()
    res = {'parity': {}, 'ms': {}}
    for h, w, c4, f, tag in BOTTLENECKS:
        x = _uniform(gen, (batch, h, w, c4), -1, 1).to(torch.bfloat16)
        ws = (_normal(gen, (1, 1, c4, f), .05),
              _normal(gen, (f,), .1),
              _normal(gen, (3, 3, f, f), .05),
              _normal(gen, (f,), .1),
              _normal(gen, (1, 1, f, c4), .05),
              _normal(gen, (c4,), .1))
        am = [torch.tensor(v, device=DEV) for v in (1.0, 2.0, 2.0)]
        xs = x[:1]
        print(f'[{tag}] parity (b1)', flush=True)
        with torch.no_grad():
            _parity(bf.fused_bottleneck_cuda(xs, *ws),
                    bf.fused_bottleneck_reference(xs, *ws),
                    f'{tag} K5 vs plain (b1, bf16)', res['parity'])
            _parity(bf.fused_bottleneck_q8_cuda(xs, *ws, *am),
                    bf.fused_bottleneck_q8_reference(xs, *ws, *am),
                    f'{tag} K5 q8 vs plain int8 (b1)', res['parity'])
        px = x.numel() // c4
        ops = 2 * px * 17 * f * f          # three convs: 17 F^2 a pixel

        def bound_of(name, x=x, ws=ws, ops=ops):
            q8 = 'int8' in name or 'q8' in name
            wbytes = sum(t.numel() * (4 if t.dim() == 1 else
                                      (1 if q8 else 2)) for t in ws)
            return bound(2 * x.numel() * 2 + wbytes, ops,
                         'int8' if q8 else 'bf16')
        with torch.no_grad():
            res['ms'][tag] = _time([
                ('plain 3-conv bf16',
                 lambda: bf.fused_bottleneck_reference(x, *ws), True),
                ('K5 bf16', lambda: bf.fused_bottleneck_cuda(x, *ws), False),
                ('plain 3-conv int8',
                 lambda: bf.fused_bottleneck_q8_reference(x, *ws, *am), True),
                ('K5 q8', lambda: bf.fused_bottleneck_q8_cuda(x, *ws, *am),
                 False),
            ], batch, bound_of, f'[{tag}] ')
        if tag == 'C2':
            res['epilogue'] = _epilogue_at(x, gen, res['parity'], bound_of)
        del x, ws
        torch.cuda.empty_cache()
    return res


def _epilogue_at(x, gen, parity, bound_of):
    """At the identity block of ``x`` (NHWC bf16): the bf16 ``Bottleneck``
    on its unfused route and on its epilogue route, and the conv epilogue
    alone at conv3's output (bn3, the identity residual, ReLU) against the
    unfused passes; ``{variant: {'ms', 'bound_ms', 'bound_by'}}``, the
    epilogue's with ``bound_share``."""
    import torch

    from ..models.resnet import Bottleneck
    from ..ops import conv_epilogue as E
    from ..ops.route import kernels
    c4 = x.shape[-1]
    torch.manual_seed(SEED)
    block = Bottleneck(c4, c4 // 4).to(DEV)
    xc = x.permute(0, 3, 1, 2)                       # channels_last NCHW
    a = _normal(gen, xc.shape, 1.0).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    inv, b = block.bn3.affine(torch.bfloat16)

    def unfused():
        return torch.relu(block.bn3(a) + xc)

    def kernel():
        return E.conv_epilogue_cuda(work, inv, b, xc)
    with torch.no_grad():
        work = a[:1].clone()
        _parity(E.conv_epilogue_cuda(work, inv, b, xc[:1]),
                torch.relu(block.bn3(a[:1]) + xc[:1]),
                'C2 conv epilogue vs unfused (b1)', parity)
        work = a.clone()

        def unfused_block():
            with kernels(False):
                return block(xc)
        ms = _time([('block, unfused bf16', unfused_block, True),
                    ('block, epilogue route', lambda: block(xc), False)],
                   x.shape[0], bound_of, '[C2] ')
        nbytes = epilogue_bytes(tuple(a.shape), 'identity')
        ms.update(_time([('conv3 passes, unfused', unfused, True),
                         ('conv3 conv epilogue', kernel, False)],
                        x.shape[0], lambda name: bound(nbytes, 0, 'bf16'),
                        '[C2] '))
    rec = ms['conv3 conv epilogue']
    rec['bound_share'] = rec['bound_ms'] / rec['ms']
    print(f'  [C2] conv epilogue: {rec["bound_share"]:.3f} of its bytes '
          f'bound', flush=True)
    return ms


def frm_rois(gen, batch, h, w):
    """(batch, h * w, 5) rois whose centres, read by ``sample_coords``
    with the transposed quirk at scale 1 (row <- cx, col <- cy), are the
    JAX tool's points: each cell's own (row, col) moved by up to 1.5 px."""
    import torch
    rows = torch.arange(h, device=DEV, dtype=torch.float32)[None, :, None]
    cols = torch.arange(w, device=DEV, dtype=torch.float32)[None, None, :]
    py = rows + _uniform(gen, (batch, h, w), -1.5, 1.5)
    px = cols + _uniform(gen, (batch, h, w), -1.5, 1.5)
    rois = torch.zeros(batch, h * w, 5, device=DEV)
    rois[..., 0] = py.reshape(batch, -1)
    rois[..., 1] = px.reshape(batch, -1)
    rois[..., 2:4] = 1.0
    return rois


def run_frm(batch=BATCH):
    """The plain FRM gather against K2; returns {'parity': {..}, 'ms':
    {variant: {..}}}."""
    import torch

    from ..ops import frm_sample as K2
    from ..utils.kernel_timing import frm_work
    gen = _gen()
    h = w = 128
    c = 256
    feat = _uniform(gen, (batch, h, w, c), -1, 1).to(torch.bfloat16)
    rois = frm_rois(gen, batch, h, w)
    x = torch.zeros_like(feat)
    res = {'parity': {}}
    one = ([x[:1]], [feat[:1]], [rois[:1]], [1.0])
    with torch.no_grad():
        _parity(K2.frm_sample_levels_cuda(*one)[0],
                K2.frm_sample_levels_reference(*one)[0],
                'K2 vs plain gather (b1)', res['parity'])
    nbytes, ops = frm_work([feat], [rois], 1)

    def bound_of(name):
        return bound(nbytes, ops, 'f32')
    with torch.no_grad():
        res['ms'] = _time([
            ('plain gather', lambda: K2.frm_sample_levels_reference(
                [x], [feat], [rois], [1.0]), True),
            ('K2', lambda: K2.frm_sample_levels_cuda(
                [x], [feat], [rois], [1.0]), False),
        ], batch, bound_of)
    return res


SWIN_BATCH = 8
SWIN_STAGES = ((256, 96, 3), (128, 192, 6), (64, 384, 12), (32, 768, 24))
SWIN_WINDOW = 7


def swin_block(dims, heads, gen):
    """A shifted Swin block on the card whose weights make each part of the
    attention show: the bias table normal(0, 1), the linears normal(0,
    fan_in**-0.5), the norms' gains 1 and shifts 0."""
    import torch

    from ..models.swin import SwinBlock
    block = SwinBlock(dims, heads, 4 * dims, SWIN_WINDOW, True).to(DEV)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith('relative_position_bias_table'):
                p.copy_(_normal(gen, p.shape, 1.0))
            elif p.dim() == 2:
                p.copy_(_normal(gen, p.shape, p.shape[1] ** -0.5))
    return block


def run_swin(batch=SWIN_BATCH):
    """Swin's attention kernels and sub-block at the four stage shapes;
    returns {'parity': {..}, 'ms': {stage: {variant: {..}}}}."""
    import torch
    import torch.nn.functional as F

    from ..models.swin import padded
    from ..ops import swin_attn as A
    from ..utils.kernel_timing import swin_attn_work
    gen = _gen()
    res = {'parity': {}, 'ms': {}}
    win = SWIN_WINDOW
    for side, c, heads in SWIN_STAGES:
        tag = f'swin {side}x{side}x{c}'
        block = swin_block(c, heads, gen)
        msa, norm, shift = block.attn.w_msa, block.norm1, block.attn.shift
        table = msa.relative_position_bias_table
        x = _normal(gen, (batch, side, side, c), 1.0).to(torch.bfloat16)
        hp = padded(side, win)
        with torch.no_grad():
            def normed(t):
                return A.norm_pad_cuda(t, norm.weight, norm.bias, norm.eps,
                                       hp, hp)
            xs = x[:1]
            _parity(normed(xs), A.norm_pad_reference(
                xs, norm.weight, norm.bias, norm.eps, hp, hp),
                f'{tag} swin_norm_pad vs plain (b1)', res['parity'])
            qkv1 = msa.qkv(normed(xs))
            _parity(A.window_attn_cuda(qkv1, table, heads, win, shift,
                                       side, side),
                    A.window_attn_reference(qkv1, table, heads, win, shift,
                                            side, side),
                    f'{tag} swin_window_attn vs plain (b1)', res['parity'])
            qkv = msa.qkv(normed(x))
            # the same windows for the library's attention: (B, nW, heads,
            # N, 32) q, k, v and the (nW, heads, N, N) bias and mask
            place, _ = A.window_places(hp, hp, win, shift, x.device)
            q, k, v = qkv.reshape(batch, hp * hp, 3, heads, -1)[
                :, place.reshape(-1)].view(
                batch, place.shape[0], win * win, 3, heads, -1).permute(
                3, 0, 1, 4, 2, 5).contiguous().unbind(0)
            mask = msa.bias(side, side, shift, torch.bfloat16, x.device)
        work = swin_attn_work(batch, side, side, c, heads, win)

        def bound_of(name, work=work):
            if 'norm' in name:
                return work['swin_norm_pad']
            if 'sub-block' in name:
                return None
            return work['swin_window_attn']
        with torch.no_grad():
            res['ms'][tag] = _time([
                ('norm1 + pad, plain', lambda: A.norm_pad_reference(
                    x, norm.weight, norm.bias, norm.eps, hp, hp), True),
                ('swin_norm_pad', lambda: normed(x), False),
                ('window attn, plain', lambda: A.window_attn_reference(
                    qkv, table, heads, win, shift, side, side), True),
                ('swin_window_attn', lambda: A.window_attn_cuda(
                    qkv, table, heads, win, shift, side, side), False),
                ('window attn, library (SDPA)',
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask), False),
                ('sub-block, eager', lambda: x + block.attn(norm(x)), False),
                ('sub-block, kernels',
                 lambda: x + block.attn.kernel_forward(x, norm), False),
            ], batch, bound_of, f'[{tag}] ')
        del x, qkv, q, k, v, block
        torch.cuda.empty_cache()
    return res


RUNS = {'stem': run_stem, 'bottleneck': run_bottleneck, 'frm': run_frm,
        'swin': run_swin}


def main(argv=None):
    """Run the subcommand on the card; returns {subcommand: its run's
    result}. Raises SystemExit without a card."""
    p = argparse.ArgumentParser(
        description='On-card A/B of the serving kernels')
    p.add_argument('which', nargs='?', default='all',
                   choices=['all', *RUNS])
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench: no CUDA card; the kernels run on '
                         'the card only')
    from .. import _ext
    _ext.lib()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print('device:', torch.cuda.get_device_name(0), flush=True)
    return {name: run() for name, run in RUNS.items()
            if args.which in (name, 'all')}


if __name__ == '__main__':
    main()
