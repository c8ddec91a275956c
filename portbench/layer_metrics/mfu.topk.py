"""mfu.topk (%): the seen-filter top-K call's share of the card's bf16
peak: the untraced window's pairs a second times the operations a pair,
from the configuration's widths (``counts.pair_mfu``)."""
from portbench.counts import pair_mfu as read  # noqa: F401
