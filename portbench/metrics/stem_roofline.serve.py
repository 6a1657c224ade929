"""K3's share of its roofline (%): the least time of the stem's problem
(``work/kernels.py``: the 7x7/s2 conv, BN, ReLU and the 3x3/s2 max-pool
of the batch, bf16) over the device time of the ``stem_conv_pool``
kernels in the traced steps."""
from portbench.work import kernels


def read(run):
    t = run['trace'].kernel_s('stem_conv_pool_kernel')
    if not t:
        return None
    tr = run['traffic']
    b = tr['batch']
    least = kernels.bound(*kernels.stem_work(b, tr['size'], tr['size']),
                          'bf16')[0]
    return 100.0 * least * run['steps'] / t
