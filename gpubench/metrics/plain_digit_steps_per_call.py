"""Blind-rotation steps a call whose gadget digits were made outside K1's
epilogue (by ``digit_planes`` on the kernel paths, inside the plain step
on the others): the attribute ``plain_digit_steps`` of the stretch's
``blind_rotate.steps`` spans (``ops/blind_rotate_ntt.py:scan``), summed
and divided by the calls.  1 a rotation where K1 writes the next step's
digits, every step where they are remade.  Nothing where a span lacks the
attribute or the stretch holds no call (gpubench/program.py)."""

from gpubench import program


def read(t):
    found = program.spans(t)
    if found is None:
        return None
    n = [s.attrs.get("plain_digit_steps") for s in found
         if s.name == "blind_rotate.steps"]
    if not n or None in n:
        return None
    return sum(n) / t.calls
