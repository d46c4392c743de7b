"""setup_s: process start to the window's first submit (scene, renderer,
kernels built or found built, graph capture, warm frames); host clock."""


def read(run):
    return run.setup_s
