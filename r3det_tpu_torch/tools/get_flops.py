"""Parameter count and FLOPs of a config's detector.

    python -m r3det_tpu_torch.tools.get_flops CONFIG [--shape H [W]]
        [--device cuda] [--cfg-options k=v ...]

Port of ``tools/analysis_tools/get_flops.py``. The parameter count is the
JAX tool's (every parameter, the FrozenBN affines included). The FLOPs
differ in kind: the JAX tool prints XLA's cost analysis of the compiled
forward; this tool counts with ``torch.utils.flop_counter.FlopCounterMode``
over one forward of a (1, H, W, 3) f32 image through the plain route
(under ``ops/route.py``'s ``kernels(False)``, the same function as the
kernel route),
which counts the convolutions and matmuls, two FLOPs a multiply-add. The
hand kernels would be opaque to the counter, which is why the plain route
runs. It runs on the card unless given ``--device cpu``.
"""
import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Model FLOPs and params')
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs='+', default=[1024, 1024])
    p.add_argument('--cfg-options', nargs='+', default=[])
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def count(model, shape):
    """(parameters, FLOPs of one forward of a (1, h, w, 3) zero image on
    the plain route) of ``model``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops.route import kernels
    n_params = sum(p.numel() for p in model.parameters())
    device = next(model.parameters()).device
    x = torch.zeros((1,) + tuple(shape) + (3,), device=device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), kernels(False), counter:
        model(x)
    return n_params, counter.get_total_flops()


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..utils.builder import build_from_config
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(dict(kv.split('=', 1) for kv in args.cfg_options))
    model, _ = build_from_config(cfg, dtype=torch.float32,
                                 device=args.device)
    h, w = (args.shape * 2)[:2]
    n_params, flops = count(model, (h, w))
    print(f'input shape: (1, {h}, {w}, 3)')
    print(f'params: {n_params / 1e6:.2f} M')
    print(f'flops:  {flops / 1e9:.2f} GFLOPs (FlopCounterMode, plain '
          'route: convolutions and matmuls; the hand kernels are opaque '
          'to it)')
    return n_params, flops


if __name__ == '__main__':
    main()
