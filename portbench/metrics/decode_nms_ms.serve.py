"""ms a predict step from the end of the model's forward to the end of
``detector_predict`` (decode, candidate selection and ``ops.nms`` with
K1, its host syncs included): the predict span less the forward span,
both device spans between CUDA events, averaged over the traced steps."""


def read(run):
    s = run['spans']
    if 'predict' not in s or 'forward' not in s:
        return None
    return (s['predict'] - s['forward']) / run['steps']
