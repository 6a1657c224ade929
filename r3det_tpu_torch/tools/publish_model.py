"""Publish a checkpoint: strip the optimizer state, hash-suffix the name.

    python -m r3det_tpu_torch.tools.publish_model IN_CKPT OUT_CKPT

Port of ``tools/model_converters/publish_model.py`` for the port's
``torch.save`` checkpoints (``utils/checkpoint.py::publish_checkpoint``):
writes ``OUT-<sha256[:8]>.pt`` holding the state dict alone.
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description='Publish a checkpoint')
    p.add_argument('in_ckpt')
    p.add_argument('out_ckpt')
    args = p.parse_args(argv)
    from ..utils.checkpoint import publish_checkpoint
    final = publish_checkpoint(args.in_ckpt, args.out_ckpt)
    print(f'published -> {final}')
    return final


if __name__ == '__main__':
    main()
