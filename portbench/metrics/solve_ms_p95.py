"""End to end: the 95th percentile of every solve's latency in the
measured window, from the CUDA event recorded as the solve is submitted to
the one recorded after its last operation.  The events are read on the
device's clock, not from a profiler trace: ``BENCHMARK.json`` labels the
metric ``device_trace`` as the nearest source its schema names (a solve,
15 to 50 ms, is too short for the host's clock)."""

from portbench.roofline import percentile

UNIT = "ms"
BETTER = "lower"
MOVES = None


def read(run):
    lat = run.window.latency_ms
    return percentile(lat, 95) if lat else None
