"""RA101 true positives: torch's host syncs."""
import numpy as np
import torch


def anywhere(event, stream):
    torch.cuda.synchronize()          # line 7: explicit sync
    event.synchronize()               # line 8: an event's
    stream.synchronize()              # line 9: a stream's
    return event


# repro: hot-path
def hot_submit(x):
    a = x.item()                      # line 15
    b = x.tolist()                    # line 16
    c = x.cpu()                       # line 17
    d = x.numpy()                     # line 18
    e = x.to("cpu")                   # line 19
    f = x.to(device="cpu")            # line 20
    g = np.asarray(x)                 # line 21
    h = np.array(x)                   # line 22
    t = torch.zeros(4)
    i = float(t.sum())                # line 24: a torch call's result
    j = int(t[0])                     # line 25
    k = bool(t.any())                 # line 26
    m = float(x)                      # a parameter: not shown a tensor
    return a, b, c, d, e, f, g, h, i, j, k, m
