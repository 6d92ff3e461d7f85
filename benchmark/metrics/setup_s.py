"""setup_s: seconds from the process's start to the window's (the card,
the kernel library, the warm-up), on the host clock, less the seconds
spent making or loading the seed's inputs, which are the benchmark's."""


def read(run):
    return run["setup_s"]
