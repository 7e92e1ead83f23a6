"""Share of its roofline of kernel 4, ``bvh_closest`` (``csrc/bvh.cu``):
closest hits over the BVH, in %: the least time the H100's peaks allow for
the work the benchmark reckons (``pt_bench/work.py``) over the kernel's
device seconds in the traced window; bound by operations or bytes, whichever
is larger. Nothing when the kernel did not run."""

from pt_bench import work

KERNEL = "::bvh_closest_kernel("


def read(rec):
    n, seconds = rec.trace.kernel(KERNEL)
    if not n:
        return None
    bound, _ = work.bvh_closest(rec.reckoning, rec.paths, n)
    return work.share_pct(bound, seconds)
