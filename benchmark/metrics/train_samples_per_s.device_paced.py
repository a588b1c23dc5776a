"""train_samples_per_s.device_paced: train_samples_per_s, read alike, held
under a bound of its own in the cells whose step the device paces. A
host-paced step's rate moves with the host's load, by several per cent
between runs on a shared host, and sets the shared metric's bound; a
device-paced step's moves by a tenth of a per cent."""

from benchmark.metrics.train_samples_per_s import read  # noqa: F401
