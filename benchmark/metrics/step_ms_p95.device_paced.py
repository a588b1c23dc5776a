"""step_ms_p95.device_paced: step_ms_p95, read alike, held under a bound of
its own in the cells whose step the device paces (see
``train_samples_per_s.device_paced``)."""

from benchmark.metrics.step_ms_p95 import read  # noqa: F401
