"""Slab sweep kernels: the least time of the pairs stage 1's sweep kept
(``sweep_roofline.sweep_least_s`` of ``timings["stage1_kept_pairs"]``) over
the mean ``timings["stage1_s"]`` of the same calls (%); None where no call
reports its kept pairs."""
from portbench.readers import mean
from portbench.sweep_roofline import sweep_least_s


def read(out):
    calls = [c for c in out.calls if "stage1_kept_pairs" in c.timings
             and "stage1_s" in c.timings]
    spent = mean(c.timings["stage1_s"] for c in calls)
    if not spent:
        return None
    least = mean(sweep_least_s(c.timings["stage1_kept_pairs"])
                 for c in calls)
    return 100.0 * least / spent
