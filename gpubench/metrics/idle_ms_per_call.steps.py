"""The device's idle time a call while it runs the blind rotation's steps,
in ms: idle gaps whose midpoint lies in the device interval of a
``blind_rotate.steps`` span, placed by its CUDA event pair
(gpubench/program.py).  The gaps at the scan's kernel boundaries, and
those where the host's pace a step falls behind the device's."""

from gpubench import program


def read(t):
    return program.idle_ms_per_call(t, "steps")
