"""K1-K3 together: the least time of the layers they computed over their
device time (`work/roofline.py`)."""

from perfbench.work import roofline


def read(art):
    return roofline.share(art, ("k1", "k2", "k3"))
