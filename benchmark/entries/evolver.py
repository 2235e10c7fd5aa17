"""Client of the reference wrapper's ``Evolver``, built once; one point
per request through ``set_parameters``, ``evolve`` and ``get_flux_fla``
(a likelihood fit or an MCMC chain that waits for each point). The
interface is that of ``entries/grid_scan.py``."""

import torch


class Client:
    def __init__(self, deploy, traffic, device):
        import nusiprop_tpu_torch as nt

        phys = deploy["physics"]
        if int(traffic["batch"]) != 1:
            raise ValueError("the Evolver entry takes one point a request")
        self.ev = nt.Evolver(mphi=traffic["mphi_eV"][0], g=traffic["g"][0],
                             mntot=phys["mntot"], si=phys["si"],
                             norm=phys["norm"], device=device,
                             **deploy["config"])
        self.device = device

    def request(self, mphi, g, keep):
        self.ev.set_parameters(mphi=float(mphi[0]), g=float(g[0]))
        self.ev.evolve()
        flux = self.ev.get_flux_fla()          # numpy: waits for the card
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        return torch.from_numpy(flux)[None]
