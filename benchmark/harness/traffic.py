"""The one traffic generator: a stream of requests of (mphi, g) points
drawn from a traffic file's parameters and the run's seed.

A traffic file (``benchmark/traffic/<name>.json``) gives ``entry`` (the
client in ``entries``), ``batch`` (points per request), the log-uniform
ranges ``mphi_eV`` and ``g``, and the counts ``warm_requests``,
``trace_requests`` and ``check_points``. Every request has the same
shape whatever the seed; the seed changes only the points.
"""

import numpy as np

# stream offsets inside one seed: the warm-up points, the window's points
# and the correctness sample never share a draw
WARM, WINDOW, SAMPLE = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of one run's seed (any integer >= 0)."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(seed), stream])))


class Stream:
    """Requests of ``batch`` points, each drawn on demand."""

    def __init__(self, traffic: dict, seed: int, stream: int):
        self.batch = int(traffic["batch"])
        self.lm = np.log10(np.asarray(traffic["mphi_eV"], dtype=np.float64))
        self.lg = np.log10(np.asarray(traffic["g"], dtype=np.float64))
        self._rng = rng(seed, stream)

    def next(self):
        """(mphi, g) float64 arrays of one request's points."""
        u = self._rng.random((2, self.batch))
        mphi = 10.0 ** (self.lm[0] + (self.lm[1] - self.lm[0]) * u[0])
        g = 10.0 ** (self.lg[0] + (self.lg[1] - self.lg[0]) * u[1])
        return mphi, g

    def kept(self, mphi, g):
        """Indices of the points of a request whose flux is kept for the
        correctness sample: the strongest coupling, the lightest mediator
        (its resonance deepest in the window) and one drawn at random."""
        return sorted({int(np.argmax(g)), int(np.argmin(mphi)),
                       int(self._rng.integers(self.batch))})


def sample(kept_mphi, kept_g, n: int, seed: int):
    """Which of the kept points the reference checks: the strongest
    coupling and the lightest mediator among all of them, then points
    drawn from the seed, ``n`` in all (fewer where fewer were kept)."""
    total = len(kept_g)
    chosen = [int(np.argmax(kept_g)), int(np.argmin(kept_mphi))]
    rest = [i for i in rng(seed, SAMPLE).permutation(total)
            if i not in chosen]
    chosen = list(dict.fromkeys(chosen)) + [int(i) for i in rest]
    return sorted(chosen[:n])
