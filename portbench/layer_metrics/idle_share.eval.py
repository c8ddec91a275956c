"""idle_share.eval (%): the share of the untraced full-catalog top-K
window in which no operation ran on the device, from the device-only
slice's busy seconds a unit of work (``counts.idle_share``)."""
from portbench.counts import idle_share as read  # noqa: F401
