"""True negatives: the same calls where they are allowed."""
import numpy as np
import torch


# repro: sync-boundary designated result point of this fixture
def result(event, x):
    event.synchronize()
    torch.cuda.synchronize()

    def call():                       # a closure of a boundary is in it
        torch.cuda.current_stream().synchronize()
    call()
    return x.cpu().numpy(), x.item(), float(torch.ones(1))


# repro: hot-path
def hot_ok(x):
    t = torch.zeros(4, device=x.device)
    n = int(t.shape[0])               # .shape read: host metadata
    if t.numel() > 2 and t.dim() == 1:
        n += 1
    if t.device.type == "cuda":
        n += 1
    # repro: allow[host-sync] fixture: a deliberate read
    v = x.item()
    w = t.tolist()  # repro: allow[host-sync] the same-line form
    # repro: allow[tensor-branch] fixture: a deliberate branch
    if t.sum() > 0:
        n += 1
    ids = np.arange(n)                # numpy made on the host: no sync
    return n, v, w, torch.from_numpy(ids)


def cold(x):
    # not a hot path: reads are the caller's business
    return x.item(), x.cpu(), float(torch.ones(1)), np.asarray(x)
