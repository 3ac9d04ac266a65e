"""K1's share of its roofline over the traced window (`work/roofline.py`)."""

from perfbench.work import roofline


def read(art):
    return roofline.share(art, ("k1",))
