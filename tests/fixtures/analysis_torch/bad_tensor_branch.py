"""RA102 true positives: Python branches on tensors in a hot path."""
import torch


# repro: hot-path
def hot(x, n):
    t = torch.arange(n)
    s = t.sum() + 1
    if s > 0:                         # line 9: tensor branch
        n += 1
    while t.max() > 0:                # line 11: tensor loop
        t = t - 1
    if x > 0:                         # a parameter: not shown a tensor
        n += 1
    if t.shape[0] > 4:                # .shape: host metadata
        n += 1
    return n


def cold(n):
    t = torch.arange(n)
    if t.sum() > 0:                   # not a hot path: not flagged
        return 1
    return 0
