"""launches.point: device kernels launched per one-point request
(``Evolver.evolve`` through ``transport.evolve_batched``, the mass
spectrum, the source and the route under it), counted in the trace. At
batch 1 the host issues them one by one, so their number sets the pace."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["kernels"]:
        return None
    return len(tr["kernels"]) / tr["requests"]
