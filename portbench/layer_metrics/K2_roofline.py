"""K2_roofline (%): kernel K2 (``gated_pairwise_kernel``, exact gated
fusion) against its roofline (``counts.pair_roofline_share``)."""
from portbench import counts


def read(run):
    return counts.pair_roofline_share(run, 'gated_pairwise_kernel')
