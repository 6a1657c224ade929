"""On-card A/B of the serving kernels against their plain PyTorch forms.

    python -m r3det_tpu_torch.tools.kernel_bench [stem|bottleneck|frm|all]

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
  weights;
- ``frm``: a (32, 128, 128, 256) bf16 map sampled within +-1.5 px of each
  cell: the plain gather against K2 (``ops/frm_sample.py``). K2 takes
  rois: their ``sample_coords`` (the transposed quirk included) give the
  points, and ``x`` is zero, so both compute ``feat + sample``.

Inputs come from a seeded generator on the card (the JAX tool draws the
same distributions with numpy). There is no CPU fallback: without a card
it exits non-zero.
"""
import argparse
import sys

from ..utils.kernel_timing import bound, cuda_ms

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
        b_ms, by = bound_of(name)
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
        del x, ws
        torch.cuda.empty_cache()
    return res


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
    with torch.no_grad():
        _parity(K2.frm_sample_cuda(x[:1], feat[:1], rois[:1], 1.0),
                K2.frm_sample_reference(x[:1], feat[:1], rois[:1], 1.0),
                'K2 vs plain gather (b1)', res['parity'])
    nbytes, ops = frm_work([feat], [rois], 1)

    def bound_of(name):
        return bound(nbytes, ops, 'f32')
    with torch.no_grad():
        res['ms'] = _time([
            ('plain gather', lambda: K2.frm_sample_reference(
                x, feat, rois, 1.0), True),
            ('K2', lambda: K2.frm_sample_cuda(x, feat, rois, 1.0), False),
        ], batch, bound_of)
    return res


RUNS = {'stem': run_stem, 'bottleneck': run_bottleneck, 'frm': run_frm}


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
