"""``setup_s``: seconds from the process's start to the window's, on the
host's clock: imports, the data and weights made on the card, the kernels
loaded (built on a checkout's first run), and the set-up ``fit`` calls."""


def read(record):
    return record.setup_s
