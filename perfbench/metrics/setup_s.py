"""Set-up seconds: from the process's start to the first timed study
(imports, the kernels' load or build, the weights, the store, the phantoms
and the warm-up), on the host clock."""


def read(art):
    return art["setup_s"]
