"""Client of ``nusiprop_tpu_torch.grid_scan``: a batch of points per
request, as an exclusion-contour scan runs.

Every client file under ``entries/`` gives ``Client(deploy, traffic,
device)``, built once in set-up, whose ``request(mphi, g, keep)`` runs one
request as a user of that entry point does, waits for its result, and
returns the flavour flux of the points ``keep`` as a (len(keep), 3, NE)
float64 host tensor for the correctness sample.
"""

import torch


class Client:
    def __init__(self, deploy, traffic, device):
        import nusiprop_tpu_torch as nt

        self.nt = nt
        self.cfg = nt.Config(**deploy["config"])
        phys = deploy["physics"]
        self.fixed = (phys["mntot"], phys["si"], phys["norm"])
        self.device = device

    def request(self, mphi, g, keep):
        p = self.nt.PhysicsParams.create(mphi, g, *self.fixed,
                                         device=self.device)
        res = self.nt.grid_scan(p, self.cfg)
        idx = torch.as_tensor(keep, device=res.flux_fla.device)
        # the kept answers come to the host, as a scan's results do, so
        # that they hold no card memory through the window
        kept = res.flux_fla.index_select(0, idx).cpu()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        return kept
