"""Process start to the window's first call, in s (host clock): imports,
the keys, the client's encryptions, the warm-up and, in a checkout's first
run, the kernels' build."""


def read(w):
    return w.setup_s
