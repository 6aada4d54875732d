"""The card's time in Part A's phase of the IMU / wheel guess where on and the
NDT align (to the event in `odometry.step` after the align): the device
engine's `stage_seconds["device.part_a.align"]`, timing events captured into
Part A's CUDA graph, read for the last replay of each chunk after its
readback, summed over the window's sessions, per sampled scan
(`device.samples`). None on the CPU and for a program without the events."""
from slambench.metrics import program_spans

UNIT, SOURCE = "ms/scan", "program_span"
LAYER, MOVES = program_spans.LAYER, program_spans.MOVES
KEY = "device.part_a.align"


def read(ctx):
    return program_spans.per_sample_ms(ctx, KEY)
