"""Plain float64 reference of the nuSIprop flux evolve, for the benchmark's
correctness check.

A straightforward implementation of the reference engine's semantics
(nuSIprop.hpp), written from its equations and not from any package of
this repository: it imports only ``math``, ``numpy`` and ``torch``.
Everything is recomputed from the deployment and the (mphi, g) points:

* the energy and redshift grids (nuSIprop.hpp:113-128, 218-233);
* the mass spectrum by bisection on the total mass (aux.hpp:12-50), the
  lightest mass floored at ``MN_FLOOR``;
* |U|^2 of the PMNS matrix from the NuFIT 5.0 angles (nuSIprop.hpp:131-163);
* the DSNB source (Fermi-Dirac at T = 6 MeV times the supernova rate,
  nuSIprop.hpp:607-662) integrated over each bin by Gauss-Legendre
  quadrature, not through the polylogarithm antiderivative;
* the kernel tables: the s channel in closed form (a Breit-Wigner in
  s = 2 mn E / mphi^2), the non-resonant channels (t/u, t-u, s-t/s-u) by
  Gauss-Legendre quadrature of their integrands over each bin, or bin
  pair, with the resonance x = 1 of the s-t/s-u factor subtracted in
  closed form where a bin lies near it;
* the implicit redshift march (nuSIprop.hpp:257-315): per node a 3x3
  solve per bin and the regeneration feed from the bins above, closed as
  one unit upper-triangular solve.

``precision="tf32"`` is the control of a float32 deployment: every table
entry is rounded to TF32's 10-bit mantissa and every march quantity to
float32's, with float64's exponent range (so only the precision drops).

Majorana and Dirac s-channel, both orderings, any flavour; the
non-resonant channels for Majorana only; the DSNB source only.
"""

import math

import numpy as np
import torch

PI = math.pi
F64 = torch.float64

# NuFIT 5.0 splittings [eV^2] and angles [deg] (nuSIprop.hpp:131-144, 184-189)
DMQ21 = 7.42e-5
DMQ31_NO = 2.514e-3
DMQ32_IO = -2.497e-3
ANGLES = {True: (33.44, 8.57, 49.0, 195.0), False: (33.45, 8.61, 49.3, 286.0)}
# cosmology (nuSIprop.hpp:573-605)
ND_COEFF = 4.3528e-13
H_COEFF = 1.5e-33
OMEGA_L, OMEGA_M = 0.692, 0.308
# DSNB source (nuSIprop.hpp:607-646)
T_DSNB = 6e6
ETOT_DSNB = 3 * 6.24
M_SOLAR_1E64EV = 1.989 * 56.1
RSN_PER_MSUN = 0.01
# lightest mass floor [eV]: keeps 1/(2 mn) finite for a massless state
MN_FLOOR = 1e-12
# the engine's floor on |s| and |t| (units of mphi^2) in the non-resonant
# channels: a bin whose upper end lies below it contributes nothing there,
# and a bin across it is cut at it (the s channel has no floor)
COORD_FLOOR = 1e-8

_SERIES_BELOW = 0.1   # small-argument series of the Gamma shapes
_NEAR = 4.0           # a bin within this many widths of x = 1 is "near"


def _gl(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


GL8 = _gl(8)
GL6 = _gl(6)
GL4 = _gl(4)


def _quad(f, a, b, rule):
    """int_a^b f over the last axis' intervals, elementwise in a, b."""
    c, w = rule
    d = b - a
    acc = torch.zeros_like(d)
    for ci, wi in zip(c, w):
        acc = acc + wi * f(a + ci * d)
    return acc * d


def round_mantissa(x, bits):
    """x with its mantissa rounded to ``bits`` explicit bits (nearest)."""
    m, e = torch.frexp(x)
    scale = float(2 ** (bits + 1))
    return torch.ldexp(torch.round(m * scale) / scale, e)


# ---------------------------------------------------------------------------
# grids, masses, mixing, cosmology, source
# ---------------------------------------------------------------------------

def grid(NE, lEmin, lEmax, zmax):
    span = lEmax - lEmin
    ratio = 10.0 ** (span / NE)
    Nz = int(math.log(1.0 + zmax) / math.log(ratio) + 2.0)
    edge = [math.pow(10.0, lEmin + span * i / NE) for i in range(NE + 1)]
    Emin, Emax = np.array(edge[:-1]), np.array(edge[1:])
    E_nu = np.array([math.pow(10.0, lEmin + span * (i + 0.5) / NE)
                     for i in range(NE)])
    z = np.array([math.pow(ratio, i) for i in range(Nz)]) - 1.0
    e = np.arange(NE + Nz - 2)
    scale = np.array([math.pow(ratio, max(0, k - (NE - 1))) for k in e])
    idx = np.minimum(e, NE - 1)
    return dict(NE=NE, Nz=Nz, Emin=Emin, Emax=Emax, E_nu=E_nu, z=z,
                Emin_ext=Emin[idx] * scale, Emax_ext=Emax[idx] * scale,
                dlogz=math.log(ratio))


def masses(mntot, normal_ordering):
    """The three mass eigenvalues [eV]."""
    if normal_ordering:
        def total(m):
            return m + math.sqrt(m * m + DMQ21) + math.sqrt(m * m + DMQ31_NO)
    else:
        a = abs(DMQ32_IO)

        def total(m):
            return m + math.sqrt(m * m + a) + math.sqrt(m * m + a - DMQ21)
    lo, hi = 0.0, mntot
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if total(mid) < mntot else (lo, mid)
    mL = 0.5 * (lo + hi)
    if normal_ordering:
        mn = [mL, math.sqrt(DMQ21 + mL * mL), math.sqrt(DMQ31_NO + mL * mL)]
    else:
        m2 = math.sqrt(mL * mL - DMQ32_IO)
        mn = [math.sqrt(m2 * m2 - DMQ21), m2, mL]
    return np.maximum(np.array(mn), MN_FLOOR)


def pmns_sq(normal_ordering):
    t12, t13, t23, dcp = (math.radians(a) for a in ANGLES[normal_ordering])
    c12, s12, c13, s13 = math.cos(t12), math.sin(t12), math.cos(t13), math.sin(t13)
    c23, s23 = math.cos(t23), math.sin(t23)
    ph = complex(math.cos(dcp), math.sin(dcp))
    U = np.array([
        [c12 * c13, s12 * c13, s13 / ph],
        [-s12 * c23 - c12 * s23 * s13 * ph, c12 * c23 - s12 * s23 * s13 * ph,
         s23 * c13],
        [s12 * s23 - c12 * c23 * s13 * ph, -c12 * s23 - s12 * c23 * s13 * ph,
         c23 * c13]])
    return np.abs(U) ** 2


def hubble(z):
    return H_COEFF * math.sqrt(OMEGA_L + OMEGA_M * (1.0 + z) ** 3)


def n_bath(z):
    return ND_COEFF * (1.0 + z) ** 3


def sn_rate(z):
    zp1 = 1.0 + z
    sfr = (zp1 ** -34.0 + (zp1 / 5161.0) ** 3.0 + (zp1 / 9.06) ** 35.0) ** -0.1
    return sfr * RSN_PER_MSUN / M_SOLAR_1E64EV


def dsnb_source(z, Emin, Emax, device):
    """Neutrinos injected per bin at redshift z: the Fermi-Dirac spectrum
    at E (1 + z) times (1 + z)^2 times the supernova rate, integrated over
    each bin. (NE,) float64."""
    T = T_DSNB
    c = ETOT_DSNB * 120.0 / (42.0 * PI ** 4 * T ** 4) * (1.0 + z) ** 2

    def fd(E):
        u = E * (1.0 + z) / T
        return c * E * E * torch.exp(-u) / (1.0 + torch.exp(-u))

    a = torch.as_tensor(Emin, dtype=F64, device=device)
    b = torch.as_tensor(Emax, dtype=F64, device=device)
    return _quad(fd, a, b, GL8) * sn_rate(z)


# ---------------------------------------------------------------------------
# kernel tables; x, y, u are s, t, u in units of mphi^2 (x + y + u = 0)
# ---------------------------------------------------------------------------

def _r0_int(a, b, gr, taylor_below=None):
    """int_a^b dx / ((x - 1)^2 + gr^2). With ``taylor_below``, a bin whose
    upper end lies below it takes the first-order expansion in x that the
    reference engine's float64 closed forms use there (nuSIprop.hpp:
    779-791, 956-965, 1264-1269)."""
    exact = torch.atan2((b - a) * gr, gr * gr + (a - 1.0) * (b - 1.0)) / gr
    if taylor_below is None:
        return exact
    g2 = 1.0 + gr * gr
    d = b - a
    return torch.where(b < taylor_below,
                       ((g2 + 2.0 * a) * d + d * d) / (g2 * g2), exact)


def _r1_int(a, b, gr):
    """int_a^b (x - 1) dx / ((x - 1)^2 + gr^2)."""
    return 0.5 * torch.log1p((b - a) * (a + b - 2.0)
                             / ((a - 1.0) ** 2 + gr * gr))


def _floor(x):
    return torch.clamp(x, min=COORD_FLOOR)


def _near(a, b):
    dist = torch.where((a - 1.0) * (b - 1.0) <= 0.0, 0.0,
                       torch.minimum(torch.abs(a - 1.0), torch.abs(b - 1.0)))
    return dist < _NEAR * (b - a)


def _res_int(h, h1, dh1, a, b, gr, rule):
    """int_a^b h(x) (x - 1) / ((x - 1)^2 + gr^2) dx. Far from x = 1 by
    quadrature; near it, h(1) and h'(1) (tensors broadcasting against a)
    are taken out in closed form and the smooth rest,
    (h(x) - h(1)) / (x - 1), by quadrature; what is left out is of order
    gr * h'' * (b - a)."""
    gr2 = gr * gr
    far = _quad(lambda x: h(x) * (x - 1.0) / ((x - 1.0) ** 2 + gr2),
                a, b, rule)

    def slope(x):
        dx = x - 1.0
        small = torch.abs(dx) < 1e-7
        return torch.where(small, dh1, (h(x) - h1) / torch.where(small, 1.0, dx))

    near = (h1 * _r1_int(a, b, gr) + _quad(slope, a, b, rule)
            - dh1 * gr2 * _r0_int(a, b, gr))
    return torch.where(_near(a, b), near, far)


def _series_p(z):
    """P(z) = (z (2 + z) - 2 (1 + z) log1p z) / z^2, whence
    f_t+u = P / (1 + z) and f_t-u = P / (2 + z)."""
    zs = torch.clamp(z, max=_SERIES_BELOW)
    ser = torch.zeros_like(z)
    for k in range(30, 0, -1):
        ser = ser * zs + 2.0 * (-1.0) ** (k + 1) / ((k + 1) * (k + 2))
    ser = ser * zs
    zd = torch.clamp(z, min=_SERIES_BELOW)
    direct = (zd * (2.0 + zd) - 2.0 * (1.0 + zd) * torch.log1p(zd)) / (zd * zd)
    return torch.where(z < _SERIES_BELOW, ser, direct)


def _h_st(z):
    """2 (z - log1p z) / z, the s-t shape of Gamma."""
    zs = torch.clamp(z, max=_SERIES_BELOW)
    ser = torch.zeros_like(z)
    for k in range(30, 0, -1):
        ser = ser * zs + 2.0 * (-1.0) ** (k + 1) / (k + 1)
    ser = ser * zs
    zd = torch.clamp(z, min=_SERIES_BELOW)
    direct = 2.0 * (zd - torch.log1p(zd)) / zd
    return torch.where(z < _SERIES_BELOW, ser, direct)


H_ST_1 = 2.0 * (1.0 - math.log(2.0))
DH_ST_1 = 2.0 * (math.log(2.0) - 0.5)


def _gamma(a, b, gr, non_resonant, taylor_below=None):
    """Absorption over one bin [a, b] of s, per state, / g^4."""
    near = _near(a, b)
    s_close = _r1_int(a, b, gr) + _r0_int(a, b, gr)
    if taylor_below is not None:
        # the engine's closed form throughout, its expansion below the cut
        near = torch.ones_like(near)
        s_close = _r1_int(a, b, gr) + _r0_int(a, b, gr, taylor_below)
    s_far = _quad(lambda x: x / ((x - 1.0) ** 2 + gr * gr), a, b, GL8)
    out = torch.where(near, s_close, s_far) / (16.0 * PI)
    if non_resonant:
        def shapes(x):
            P = _series_p(x)
            return 2.0 * P / (1.0 + x) + P / (2.0 + x)

        fa, fb = _floor(a), _floor(b)
        nr = _quad(shapes, fa, fb, GL8) + _res_int(
            _h_st, H_ST_1, DH_ST_1, fa, fb, gr, GL8)
        out = out + torch.where(b >= COORD_FLOOR, nr, 0.0) / (16.0 * PI)
    return out


def _pair_integrand(x, y):
    """The non-resonant bin-to-bin integrand without its resonance part:
    (2 r_t^2 + 2 r_u^2 + 2 r_t r_u) / x^2, r_v = v / (v - 1)."""
    u = -(x + y)
    rt = y / (y - 1.0)
    ru = u / (u - 1.0)
    return 2.0 * (rt * rt + ru * ru + rt * ru) / (x * x)


def _nr_region(xa, xb, ya, yb, gr, triangle):
    """int over y in [ya, yb] and x in [xa, xb] (or, with ``triangle``,
    x in [-y, xb]) of _pair_integrand + 2 (r_t + r_u) R1(x) / x, where
    R1 = (x - 1) / ((x - 1)^2 + gr^2)."""
    cy, wy = GL4 if not triangle else GL6
    dy = yb - ya
    acc = torch.zeros_like(dy)
    for ci, wi in zip(cy, wy):
        y = ya + ci * dy
        lo = -y if triangle else xa
        rt = y / (y - 1.0)
        smooth = _quad(lambda x: _pair_integrand(x, y), lo, xb, GL6)

        def h(x):
            u = -(x + y)
            return 2.0 * (rt + u / (u - 1.0)) / x

        u1 = -(1.0 + y)
        h1 = 2.0 * (rt + u1 / (u1 - 1.0))
        dh1 = 2.0 / (u1 - 1.0) ** 2 - h1
        acc = acc + wi * (smooth + _res_int(h, h1, dh1, lo, xb, gr, GL6))
    return acc * dy


def _alphatilde(a, b, gr, non_resonant, dirac_half, taylor_below=None):
    """Same-bin regeneration over [a, b] of s, per state, / g^4."""
    near = _near(a, b)
    s_close = _r1_int(a, b, gr) + (1.0 - a) * _r0_int(a, b, gr)
    if taylor_below is not None:
        near = torch.ones_like(near)
        s_close = (_r1_int(a, b, gr)
                   + (1.0 - a) * _r0_int(a, b, gr, taylor_below))
    s_far = _quad(lambda x: (x - a) / ((x - 1.0) ** 2 + gr * gr), a, b, GL8)
    out = dirac_half * torch.where(near, s_close, s_far) / (8.0 * PI)
    if non_resonant:
        fa, fb = _floor(a), _floor(b)
        nr = _nr_region(None, fb, -fb, -fa, gr, True)
        out = out + torch.where(b >= COORD_FLOOR, nr, 0.0) / (16.0 * PI)
    return out


def tables(mphi, g, mn, Wf, ext_lo, ext_hi, majorana, non_resonant,
           taylor_below=None):
    """Gamma (NEXT,), alphaTilde (NEXT,) and alpha (NEXT, NEXT) of one
    point: the |U_f|^2 / (2 mn) sum over the states, g^4 applied.
    ``taylor_below``: see ``_r0_int`` (s channel only)."""
    dev = ext_lo.device
    if non_resonant and not majorana:
        raise NotImplementedError("the reference's non-resonant channels "
                                  "are Majorana's")
    gr = g * g / ((16.0 if majorana else 8.0) * PI)
    dirac_half = 1.0 if majorana else 0.5
    N = ext_lo.shape[0]
    rows, cols = torch.triu_indices(N, N, 1, device=dev)
    G = torch.zeros(N, dtype=F64, device=dev)
    At = torch.zeros(N, dtype=F64, device=dev)
    A = torch.zeros(N * N, dtype=F64, device=dev)
    for k in range(3):
        c = 2.0 * mn[k] / (mphi * mphi)
        a, b = c * ext_lo, c * ext_hi
        wk = Wf[k] / (2.0 * mn[k])
        G = G + wk * _gamma(a, b, gr, non_resonant, taylor_below)
        At = At + wk * _alphatilde(a, b, gr, non_resonant, dirac_half,
                                   taylor_below)
        q = _r0_int(a, b, gr, taylor_below)
        pair = dirac_half * ((b - a)[rows] * q[cols]) / (8.0 * PI)
        if non_resonant:
            fa, fb = _floor(a), _floor(b)
            nr = _nr_region(fa[cols], fb[cols], -fb[rows], -fa[rows], gr,
                            False)
            ok = (b[rows] >= COORD_FLOOR) & (b[cols] >= COORD_FLOOR)
            pair = pair + torch.where(ok, nr, 0.0) / (16.0 * PI)
        A[rows * N + cols] += wk * pair
    g4 = g ** 4
    return g4 * G, g4 * At, g4 * A.reshape(N, N)


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------

def evolve(mphi, g, deploy, device="cpu", precision="f64"):
    """Flavour flux (B, 3, NE) float64 of the points (mphi[b], g[b]) under
    ``deploy`` (the deployment's file as a dict: ``config`` and
    ``physics``). ``precision``: "f64", or "tf32" for the control."""
    cfg, phys = deploy["config"], deploy["physics"]
    if cfg["source"] != "dsnb":
        raise NotImplementedError("the reference's source is the DSNB")
    if precision not in ("f64", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    gr_ = grid(cfg["N_bins_E"], cfg["lEmin"], cfg["lEmax"], cfg["zmax"])
    NE, Nz = gr_["NE"], gr_["Nz"]
    mn = masses(phys["mntot"], cfg["normal_ordering"])
    Wsq = pmns_sq(cfg["normal_ordering"])
    Wf = Wsq[cfg["flav"]]
    t = lambda v: torch.as_tensor(np.asarray(v), dtype=F64, device=device)
    lo, hi = t(gr_["Emin_ext"]), t(gr_["Emax_ext"])
    tbl = [tables(float(m), float(gg), mn, Wf, lo, hi, cfg["majorana"],
                  cfg["non_resonant"], phys.get("s_taylor_below"))
           for m, gg in zip(mphi, g)]
    G, At, A = (torch.stack(x) for x in zip(*tbl))
    lowp = precision == "tf32"
    if lowp:
        G, At, A = (round_mantissa(x, 10) for x in (G, At, A))
    f32 = (lambda x: round_mantissa(x, 23)) if lowp else (lambda x: x)

    B = G.shape[0]
    dE = t(gr_["Emax"] - gr_["Emin"])
    W = t(Wf)
    eye = torch.eye(NE, dtype=F64, device=device)
    off = 1.0 - torch.eye(3, dtype=F64, device=device)
    flux = torch.zeros(B, 3, NE, dtype=F64, device=device)
    z = gr_["z"]
    for i in range(Nz - 1, 0, -1):
        zim = z[i - 1]
        ndfac = n_bath(zim) / (1.0 + zim) ** 2
        pref = (1.0 + zim) * gr_["dlogz"] / hubble(zim)
        lum = f32(dsnb_source(z[i], gr_["Emin"], gr_["Emax"], device))
        Gi = G[:, i - 1:i - 1 + NE] * ndfac
        Ati = At[:, i - 1:i - 1 + NE] * ndfac
        K = f32(A[:, i - 1:i - 1 + NE, i - 1:i - 1 + NE] * ndfac / dE)
        # (B, 3, NE): the diagonal of each bin's 3x3 system
        Zdr = 1.0 + pref * (Gi[:, None, :] * W[None, :, None]
                            - Ati[:, None, :] * (W * W)[None, :, None]) / dE
        coup = Ati / dE
        M = (torch.eye(3, dtype=F64, device=device)
             + off * coup[:, :, None, None] * (W[:, None] * W[None, :])
             / Zdr.transpose(1, 2)[..., :, None])          # (B, NE, 3, 3)
        rhs = torch.stack([(flux + pref * lum) / Zdr,
                           (pref * W[None, :, None]) / Zdr.expand_as(flux)],
                          dim=-1).transpose(1, 2)           # (B, NE, 3, 2)
        sol = f32(torch.linalg.solve(M, rhs))
        V, U = sol[..., 0], sol[..., 1]                     # (B, NE, 3)
        qv, pu = V @ W, U @ W
        T = eye - K * pu[:, None, :]
        reg = f32(torch.linalg.solve_triangular(
            T, (K @ qv[..., None]), upper=True, unitriangular=True)[..., 0])
        flux = f32((V + reg[..., None] * U).transpose(1, 2))
    flux = flux / dE
    return torch.einsum("ak,bkj->baj", t(Wsq), flux)
