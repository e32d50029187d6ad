"""The test vector's rotation by -b a call, in ms: the time the device ran
kernels inside the device intervals of the ``blind_rotate.testvec`` spans
(``ops/blind_rotate_ntt.py:blind_rotate_ntt``: ``rotate_via_ntt`` of one
test vector or one a lane, and its expansion over the batch), placed by
their CUDA event pairs, idle gaps left out, summed over the stretch and
divided by the calls (gpubench/program.py).  Nothing where the program
records no such span."""

from gpubench import program


def read(t):
    return program.busy_ms_per_call(t, "blind_rotate.testvec")
