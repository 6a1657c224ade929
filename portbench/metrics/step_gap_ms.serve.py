"""Device-idle ms a predict step over the lean sub-window (from the first
``r3det.predict`` span's begin to the last device op's end, the
detections' copies to the host included), where the profiler records device
activity alone (``bench/program_timeline.py``). Nothing to read without a
card or from a program without the recorder."""
from portbench.bench import program_timeline


def read(run):
    return program_timeline.step_gap_ms(run)
