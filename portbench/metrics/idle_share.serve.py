"""The device's idle share (%) of the traced predict steps: 1 - the union
of the device's op intervals over the traced window's wall time."""


def read(run):
    tr = run['trace']
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
