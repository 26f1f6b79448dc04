"""setup_s: from the process's start to the end of the warm-up: imports,
the kernels' libraries, the seed's weights, the cell's shapes warmed up
(the check's readings taken during the warm-up left out)."""


def read(w):
    return w["setup_s"]
