"""Host-to-device MB (1e6 bytes) a predict step: the bytes that the
program's ``copy.*`` sites count in their spans (the anchors in
``models.detectors``, the coder's means and stds in ``core.coders``), in the
lean sub-window (``bench/program_timeline.py``). Nothing to read without a
card or from a program without the recorder."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.h2d_mb(run)
