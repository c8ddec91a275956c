"""scan_other_share.topk (%): device time outside the pair kernel over the
device's busy time in the traced seen-filter slice
(``counts.scan_other_share``)."""
from portbench.counts import scan_other_share as read  # noqa: F401
