"""Process start to the window's start: imports, the card's start, the
kernel libraries (built on a checkout's first run), the program's set-up
(the exact host lensmap), the inputs and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
