"""Seconds to build or load the port's CUDA sources and host library
(``_cuda_build.build_all`` and ``load``, ``native.build``): a load from the
checkout's ``_build/`` once the first run built them."""


def read(rec):
    return rec.kernel_load_s
