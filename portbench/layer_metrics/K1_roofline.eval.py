"""K1_roofline.eval (%): kernel K1 (``pairwise_mlp_kernel``, concat
fusion) against its roofline in full-catalog evaluation
(``counts.pair_roofline_share``)."""
from portbench import counts


def read(run):
    return counts.pair_roofline_share(run, 'pairwise_mlp_kernel')
