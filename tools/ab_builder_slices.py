"""chip_smoke's builder parts (b)-(e) with their host query checks in
2 and then 4 slices a part, in turns 2, 4, 2, in one process on one
card: the parts as chip_smoke runs them (the four host builds started
in the worker pool first, then each part's device build, structures
and kernel checks), each turn timed whole.  It ran the builder's (b)-(e)
three times, ~2 min each on a slow host:

    chiprun --timeout 480 -- python3 tools/ab_builder_slices.py
"""
import multiprocessing
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(cs.SRC))
    cs.phase_device()
    cs.phase_build()
    parts = (("l1", 1_000_000, "skewed", cs.D, True),
             ("linf", cs.LINF_N, "skewed", cs.D, True),
             ("l1", cs.WIDE_N, "gaussmix", cs.WIDE_D, False),
             ("linf", cs.WIDE_N, "gaussmix", cs.WIDE_D, False))
    for slices in (2, 4, 2):
        cs.BUILDER_SLICES = slices
        pool = multiprocessing.get_context("spawn").Pool(cs.BUILDER_WORKERS)
        t0 = time.perf_counter()
        hosts = [pool.apply_async(cs.builder_host, p[:4]) for p in parts]
        pending = [cs.phase_builder_lp(m, n, pool, h, data=data, d=d,
                                       rows=rows)[1]
                   for (m, n, data, d, rows), h in zip(parts, hosts)]
        t1 = time.perf_counter()
        cs.builder_query_results(pending)
        t2 = time.perf_counter()
        print(f"ab: slices {slices}: parts {t1 - t0:.1f} s, waiting for "
              f"the query checks {t2 - t1:.1f} s, total {t2 - t0:.1f} s",
              flush=True)
        pool.close()
        pool.join()
