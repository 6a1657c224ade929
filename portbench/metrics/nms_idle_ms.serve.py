"""Device-idle ms a predict step inside the program's ``r3det.nms`` spans
(``ops.nms``: candidate selection, the budget's host sync, the sweep with
K1 and its fixpoint syncs): each span's length less the union of the
device ops inside it, in the program-traced sub-window, over its
``r3det.predict`` spans. Nothing to read from a program without spans."""
from portbench.bench import program_spans


def read(run):
    return program_spans.span_idle_ms(run, 'r3det.nms')
