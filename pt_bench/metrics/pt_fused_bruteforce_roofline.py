"""Share of its roofline of kernel 1, ``pt_fused_bruteforce``
(``csrc/megakernel.cu``): the whole path loop by brute force, in %: the
least time the H100's peaks allow for the work the benchmark reckons
(``pt_bench/work.py``) over the kernel's device seconds in the traced
window; bound by operations or bytes, whichever is larger. Nothing when the
kernel did not run."""

from pt_bench import work

KERNEL = ("::pt_fused_kernel<", "BruteGeo", "HashRng>")


def read(rec):
    n, seconds = rec.trace.kernel(KERNEL)
    if not n:
        return None
    bound, _ = work.fused_brute(rec.reckoning, rec.paths)
    return work.share_pct(bound, seconds)
