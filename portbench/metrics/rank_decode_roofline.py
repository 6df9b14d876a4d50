"""Share of its roofline that the rank kernel reaches in the traced
samples: the least time the bytes its launches need take at the card's
published memory bandwidth (64 B per distinct block row of a launch, 40 B
per query, counted in the run's counting sample), over the kernel's
device time in the trace; nothing where the traced samples' launches or
queries differ from the counting sample's (``rank_bytes`` None)."""

from portbench.readers import device_peak


def read(run):
    t = run["trace"]
    bw = device_peak(run, "hbm_bytes_per_s")
    if not t or not bw or not t.get("rank_bytes") or \
            not t["kernel_s"].get("rank_decode"):
        return None
    return 100.0 * t["rank_bytes"] / bw / t["kernel_s"]["rank_decode"]
