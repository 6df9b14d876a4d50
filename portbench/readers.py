"""What the metric readers under ``portbench/metrics/`` share.

A reader is ``read(run) -> float | None`` over the run record the harness
builds (``harness.run``): ``positions`` of one sample, ``setup_s``,
``window`` (``seconds``, ``samples`` and ``positions`` of the samples the
window completed), ``peak_bytes``, ``samples`` (each window sample's
``seconds`` by phase, as the pipeline returned them, and its ``launches``
and ``queries`` of the rank kernel), ``device`` (``kind``), ``peaks`` (the
table ``peaks.json``) and ``trace`` (None, or ``tracing.summarize``'s
record of the traced samples with ``rank_launches`` and ``rank_bytes``,
the counting sample's bytes once per traced sample, or None where their
launches or queries differ).
A reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""

from __future__ import annotations


def phase_mean(run: dict, key: str) -> float | None:
    """Seconds of one pipeline phase, summed over the window's samples and
    divided by their count; None where the pipeline reports no such
    phase."""
    got = [s["seconds"][key] for s in run["samples"]
           if key in s.get("seconds", {})]
    return sum(got) / len(got) if got else None


def device_peak(run: dict, key: str) -> float | None:
    """The published peak ``key`` of the run's card, None if the table has
    no entry for it."""
    return run["peaks"].get(run["device"]["kind"], {}).get(key)
