"""Share of its roofline of kernel 2, ``closest_bruteforce``
(``csrc/intersect.cu``): closest hits by brute force; the work of one
forward trace of the step's paths, in %: the least time the H100's peaks
allow for the work the benchmark reckons (``pt_bench/work.py``) over the
kernel's device seconds in the traced window; bound by operations or bytes,
whichever is larger. Nothing when the kernel did not run."""

from pt_bench import work

KERNEL = "::closest_kernel("


def read(rec):
    n, seconds = rec.trace.kernel(KERNEL)
    if not n:
        return None
    bound, _ = work.brute_closest(rec.reckoning, rec.paths, n)
    return work.share_pct(bound, seconds)
