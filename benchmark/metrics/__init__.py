"""Per-layer metric readers, one module a metric, named as the metric.
Each has ``read(reading) -> float | None`` (``harness.Reading``); None
where the run holds nothing to read, and the metric is then left out."""
