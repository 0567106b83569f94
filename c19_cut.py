"""Time c19's CPU run with its watershed on other counts of slices.

``chip_smoke.py`` holds config c19 on the card against the port's
``device="cpu"`` run, which it keeps under 15 s by cutting the volume to
central slices: the distance transforms to ``C19_SLICES``, the watershed to
``C19_WS_SLICES``. For each count given, this script builds c19 as
``chip_smoke.py`` does with the watershed on that many central slices and
runs it twice with ``device="cpu"``, printing each call's seconds, the
whole run's and the watershed's sweeps (the same on the card). Run it on
the host that runs ``chip_smoke.py``:

    python3 c19_cut.py 32 48 64 96
"""

import sys
import time

import chip_smoke


def main(argv) -> int:
    from elasticdeform_tpu_torch.ops import distance as ds
    sweep = ds.watershed_sweep

    def counted(*args, **kwargs):
        counted.n += 1
        return sweep(*args, **kwargs)

    # watershed_ift looks the sweep up at each call; the CPU path launches
    # nothing
    counted.launches = 0
    ds.watershed_sweep = counted
    print(f"transforms on {chip_smoke.C19_SLICES} slices")
    for k in [int(a) for a in argv] or [chip_smoke.C19_WS_SLICES]:
        chip_smoke.C19_WS_SLICES = k
        cfg = next(c for c in chip_smoke._configs() if c.name == "c19")
        for rep in (1, 2):
            counted.n = 0
            t0 = time.perf_counter()
            cfg.run("cpu")
            print(f"watershed on {k} slices: CPU run {rep} "
                  f"{time.perf_counter() - t0:.2f} s, {counted.n} watershed "
                  "sweeps", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
