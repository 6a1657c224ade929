"""K1's share of its roofline (%): the least time the problem needs on
the card (``work/kernels.py``: the live candidates' pairs j < i, a cull
test each and the integral for the pairs whose circumcircles meet, the
live boxes read and each pair's IoU written) over the device time of the
``rotated_iou`` kernels in the traced steps."""
from portbench.work import kernels


def read(run):
    t = run['trace'].kernel_s('rotated_iou_kernel')
    work = run.get('kernel_work')
    if not t or not work:
        return None
    least = 0.0
    for i in range(run['steps']):
        live, near = work[i % len(work)]
        least += kernels.bound(*kernels.iou_work(live, near), 'f32')[0]
    return 100.0 * least / t
