"""Device ms a predict step launched inside the program's ``r3det.frm.*``
spans (each refine stage's ``models.frm``: its convs and K2), in the lean
sub-window (``bench/program_timeline.py``). Nothing to read in a detector
without refine stages, without a card or from a program without the
recorder."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.stage_ms(run, 'device', 'r3det.frm.')
