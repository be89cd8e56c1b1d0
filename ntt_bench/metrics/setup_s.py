"""setup_s (end to end, host clock): the process's start to the first timed
call: imports, the kernel libraries (built on a checkout's first run), the
plan tables, inputs and key made from the seed, the warm-up of the cell's
shapes."""


def read(win):
    return win.setup_s
