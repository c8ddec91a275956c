"""launches_per_step.train (launches): device kernels in the traced
training slice over its steps (``counts.launches_per_step``)."""
from portbench.counts import launches_per_step as read  # noqa: F401
