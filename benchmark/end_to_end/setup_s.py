"""Seconds from the process's start to the window's: imports, the card's
start, loading (a checkout's first run: building) the kernel library,
the inputs drawn from the seed, the program's set-up and the warm-up of
the cell's own shapes."""


def read(win):
    return win["setup_s"]
