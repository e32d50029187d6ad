"""The device's idle time a call after it has run the blind rotation's
steps (sample extraction and its copies, the key switch), in ms: idle gaps
whose midpoint lies in a call's device interval after that of its
``blind_rotate.steps`` span, both placed by their CUDA event pairs
(gpubench/program.py)."""

from gpubench import program


def read(t):
    return program.idle_ms_per_call(t, "finish")
