"""Device-idle ms a predict step whose innermost span lies in the
program's ``r3det.nms`` (candidate selection, the budget's host sync, the
sweep), in the lean sub-window (``bench/program_timeline.py``). Nothing to
read without a card or from a program without the recorder."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.stage_ms(run, 'idle', 'r3det.nms')
