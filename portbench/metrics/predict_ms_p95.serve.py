"""The 95th percentile (ms) over every step of the untraced window of a
predict step's latency, from its call to its detections on the host (host
clock, linear between order statistics)."""
from portbench.bench.common import quantile


def read(run):
    lat = run['res'].get('latency_ms')
    return quantile(lat, 0.95) if lat else None
