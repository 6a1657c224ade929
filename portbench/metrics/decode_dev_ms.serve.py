"""Device ms a predict step launched inside the program's ``r3det.decode``
spans (``detector_predict``'s decode: top-k, the coder, sigmoid scores), in
the lean sub-window (``bench/program_timeline.py``). Nothing to read without
a card or from a program without the recorder."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.stage_ms(run, 'device', 'r3det.decode')
