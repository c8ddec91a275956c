"""mfu.train (%): the training step's share of the card's bf16 peak: the
untraced window's samples a second times three times a sample's forward
products, from the configuration's widths (``counts.train_mfu``)."""
from portbench.counts import train_mfu as read  # noqa: F401
