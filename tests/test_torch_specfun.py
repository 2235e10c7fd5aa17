"""The port's float64 special functions, (re, im) pair arithmetic and 2-D
quadrature against the JAX package and against mpmath.

The same numpy inputs (seeded) go through ``nusiprop_tpu.ops`` and
``nusiprop_tpu_torch.ops`` on the CPU. Tolerances:

* port vs JAX: <= 1e-14 of max(|value|, scale), where ``scale`` is the
  size of the terms the function subtracts (a difference function that
  crosses zero is held absolutely against its terms). The two differ only
  where XLA's and the C library's ``log``/``atan`` differ by an ulp, with
  one exception, measured here: XLA:CPU's float64 ``log1p`` is up to
  2.6e-14 (relative) off on (-0.5, -0.01), where the C library's is within
  an ulp of mpmath (``test_xla_log1p_is_the_looser_one`` pins that). The
  real dilogarithm on (0.5, 1) goes through it, so ``dilog1over1mdiff``
  is held to JAX at 5e-14 and to mpmath as tightly as before;
* port vs mpmath: the tolerances of tests/test_specfun.py for the same
  function (5e-15 for log1p_sq_ratio, 1e-13 for the complex dilogarithm,
  1e-9 for the difference functions, whose Taylor branches are O(1e-10)
  by design). These draws are not that file's: where one lands nearer a
  Taylor switch than that file's did, the port is held to the JAX
  function's own error on the same input instead (``_within``).
"""

import jax.numpy as jnp
import mpmath as mp
import numpy as np
import pytest
import torch

from nusiprop_tpu.ops import cplx as jcp
from nusiprop_tpu.ops import quadrature as jquad
from nusiprop_tpu.ops import specfun as jsf

from nusiprop_tpu_torch.ops import cplx as cp
from nusiprop_tpu_torch.ops import quadrature as quad
from nusiprop_tpu_torch.ops import specfun as sf

torch.set_num_threads(2)
mp.mp.dps = 40


def _t(x):
    return torch.as_tensor(np.array(x))


def _pos(rng, lo, hi, n):
    return 10.0 ** rng.uniform(lo, hi, n)


def _pairs(sign, seed):
    """Two same-sign arrays a factor 10^+-0.5 apart over 20 decades: every
    branch (big, small, exact) of a difference function."""
    rng = np.random.default_rng(seed)
    x = sign * _pos(rng, -8, 12, 150)
    return x, x * 10.0 ** rng.uniform(-0.5, 0.5, 150)


def _mp_li2(v):
    return mp.polylog(2, v)


def _within(err_port, err_jax, tol):
    """Each oracle error of the port is inside ``tol``, or no worse than
    the JAX function's on the same input (plus its round-off)."""
    return bool((err_port <= np.maximum(tol, err_jax * 1.001 + 1e-15)).all())


# port vs JAX, of max(|value|, scale); see the module docstring
JAX_GATE = {"dilog1over1mdiff": 5e-14}


# name -> (inputs, scale of the subtracted terms, mpmath oracle, mp tol)
REAL_DIFFS = {
    "dilogdiff": (_pairs(1.0, 1), lambda x, y: _mp_li2(-x) - _mp_li2(-y),
                  lambda x: abs(_mp_li2(-x)), 1e-9),
    "dilog1mdiff": (_pairs(1.0, 2),
                    lambda x, y: mp.re(_mp_li2(-1 - x) - _mp_li2(-1 - y)),
                    lambda x: abs(mp.re(_mp_li2(-1 - x))), 1e-9),
    "dilog1pdiff": (_pairs(-1.0, 3),
                    lambda x, y: mp.re(_mp_li2(1 + x) - _mp_li2(1 + y)),
                    lambda x: max(abs(mp.re(_mp_li2(1 + x))), 1.0), 1e-9),
    "dilog1over1mdiff": (_pairs(-1.0, 4),
                         lambda x, y: (_mp_li2(1 / (1 - x))
                                       - _mp_li2(1 / (1 - y))),
                         lambda x: abs(_mp_li2(1 / (1 - x))), 1e-9),
}


@pytest.fixture(scope="module", params=list(REAL_DIFFS))
def real_diff(request):
    name = request.param
    (x, y), oracle, scale, tol = REAL_DIFFS[name]
    got = getattr(sf, name)(_t(x), _t(y)).numpy()
    ref_j = np.asarray(getattr(jsf, name)(jnp.asarray(x), jnp.asarray(y)))
    sc = np.array([max(float(scale(mp.mpf(a))), 1e-300) for a in x])
    ref_mp = np.array([float(oracle(mp.mpf(a), mp.mpf(b)))
                       for a, b in zip(x, y)])
    return got, ref_j, sc, ref_mp, tol, JAX_GATE.get(name, 1e-14)


def test_real_diff_matches_jax(real_diff):
    got, ref_j, sc, _, _, gate = real_diff
    assert (np.abs(got - ref_j) / np.maximum(np.abs(ref_j), sc)).max() <= gate


def test_real_diff_matches_mpmath(real_diff):
    got, ref_j, sc, ref_mp, tol, _ = real_diff
    assert _within(np.abs(got - ref_mp) / sc, np.abs(ref_j - ref_mp) / sc,
                   tol)


def test_xla_log1p_is_the_looser_one():
    """The cause of the one gate above 1e-14: on (-0.5, -0.01) the C
    library's log1p (the port's) is within an ulp of mpmath and XLA:CPU's
    is not."""
    x = -np.linspace(0.01, 0.5, 200)
    ref = np.array([float(mp.log1p(mp.mpf(v))) for v in x])
    port = np.abs(torch.log1p(_t(x)).numpy() / ref - 1.0).max()
    xla = np.abs(np.asarray(jnp.log1p(jnp.asarray(x))) / ref - 1.0).max()
    assert port < 4e-16
    assert port <= xla


def test_dilog_tail_large_matches_jax():
    x = _pos(np.random.default_rng(5), 2, 12, 100)
    got = sf._dilog_tail_large(_t(x)).numpy()
    ref = np.asarray(jsf._dilog_tail_large(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-15)


def test_log1p_sq_ratio_matches_jax_and_mpmath():
    rng = np.random.default_rng(6)
    x = np.concatenate([_pos(rng, -30, 12, 300), -_pos(rng, -30, 12, 300),
                        [0.0, 1e-37, 1e12]])
    g = _pos(rng, -30, 2, x.shape[0])
    got = sf.log1p_sq_ratio(_t(x), _t(g)).numpy()
    ref_j = np.asarray(jsf.log1p_sq_ratio(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, ref_j, rtol=1e-14, atol=1e-300)
    ref = np.array([float(mp.log1p((mp.mpf(a) / mp.mpf(b)) ** 2))
                    for a, b in zip(x, g)])
    den = np.maximum(np.abs(ref), 1e-300)
    assert _within(np.abs(got - ref) / den, np.abs(ref_j - ref) / den, 5e-15)
    # |x| <= |g|: the decomposition collapses to the direct form
    xs = _t(_pos(rng, -10, 0, 100) * 0.5)
    assert torch.equal(sf.log1p_sq_ratio(xs, torch.ones_like(xs)),
                       torch.log1p(xs * xs))


def _plane(seed, n=200):
    rng = np.random.default_rng(seed)
    z = ((rng.uniform(-40, 40, n) + 1j * rng.uniform(-40, 40, n))
         * 10.0 ** rng.uniform(-3, 3, n))
    return z[np.abs(z.imag) > 1e-12]


CUT = np.array([1.5, 3.0, 10.0, 1e4, 0.3, -5.0, 0.0, 1.0])


def _cx_np(z):
    return z.re.numpy() + 1j * z.im.numpy()


def _jcx_np(z):
    return np.asarray(z.re) + 1j * np.asarray(z.im)


@pytest.mark.parametrize("form", ["li2c", "li2cx"])
def test_complex_dilog_matches_jax_and_mpmath(form):
    """Both spellings of the complex dilogarithm (complex128 and the
    (re, im) pairs), over the plane and on the real axis, where the cut
    takes the limit from below (Im = -pi ln x)."""
    for zs in (_plane(7), CUT + 0j):
        if form == "li2c":
            got = sf.li2c(_t(zs)).numpy()
            ref_j = np.asarray(jsf.li2c(jnp.asarray(zs)))
        else:
            got = _cx_np(sf.li2cx(cp.Cx(_t(zs.real), _t(zs.imag))))
            ref_j = _jcx_np(jsf.li2cx(jcp.Cx(jnp.asarray(zs.real),
                                             jnp.asarray(zs.imag))))
        err = np.abs(got - ref_j) / np.maximum(np.abs(ref_j), 1.0)
        assert err.max() <= 1e-14, err.max()
        ref = np.array([complex(mp.polylog(2, complex(z))) for z in zs])
        err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
        assert err[np.abs(ref) > 0].max() < 1e-13
    xs = CUT[:4]
    got = sf.li2c(_t(xs + 0j)).numpy()
    np.testing.assert_allclose(got.imag, -np.pi * np.log(xs), rtol=1e-13)


@pytest.mark.parametrize("fn", ["_li2_series_c", "_li2_series_cx"])
def test_li2_series_matches_jax(fn):
    rng = np.random.default_rng(8)
    z = (rng.uniform(-1, 0.5, 100) + 1j * rng.uniform(-0.7, 0.7, 100))
    z = z[np.abs(z) <= 1.0]
    if fn == "_li2_series_c":
        got = sf._li2_series_c(_t(z)).numpy()
        ref = np.asarray(jsf._li2_series_c(jnp.asarray(z)))
    else:
        got = _cx_np(sf._li2_series_cx(cp.Cx(_t(z.real), _t(z.imag))))
        ref = _jcx_np(jsf._li2_series_cx(jcp.Cx(jnp.asarray(z.real),
                                                jnp.asarray(z.imag))))
    assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-14


@pytest.mark.parametrize("form", ["dilogdiff_complex", "dilogdiff_cx"])
def test_complex_diff_matches_jax_and_mpmath(form):
    rng = np.random.default_rng(9)
    zs = rng.uniform(-200, 200, 100) + 1j * rng.uniform(-200, 200, 100)
    ws = zs * (1 + rng.uniform(-0.3, 0.3, 100))
    if form == "dilogdiff_complex":
        got = sf.dilogdiff_complex(_t(zs), _t(ws)).numpy()
        ref_j = np.asarray(jsf.dilogdiff_complex(jnp.asarray(zs),
                                                 jnp.asarray(ws)))
    else:
        got = _cx_np(sf.dilogdiff_cx(cp.Cx(_t(zs.real), _t(zs.imag)),
                                     cp.Cx(_t(ws.real), _t(ws.imag))))
        ref_j = _jcx_np(jsf.dilogdiff_cx(
            jcp.Cx(jnp.asarray(zs.real), jnp.asarray(zs.imag)),
            jcp.Cx(jnp.asarray(ws.real), jnp.asarray(ws.imag))))
    scale = np.array([max(abs(complex(mp.polylog(2, complex(z)))), 1.0)
                      for z in zs])
    assert (np.abs(got - ref_j) / scale).max() <= 1e-14
    ref = np.array([complex(mp.polylog(2, complex(z))
                            - mp.polylog(2, complex(w)))
                    for z, w in zip(zs, ws)])
    assert (np.abs(got - ref) / scale).max() < 1e-9


def test_pair_and_complex128_dilog_agree():
    """The pair form is the complex128 form in another arithmetic: the
    port's two spellings agree to round-off on the same points."""
    zs = _plane(10)
    a = sf.li2c(_t(zs)).numpy()
    b = _cx_np(sf.li2cx(cp.Cx(_t(zs.real), _t(zs.imag))))
    assert (np.abs(a - b) / np.maximum(np.abs(a), 1.0)).max() < 1e-13


# ---------------------------------------------------------------------------
# cplx: every operation of the pair type against the JAX one
# ---------------------------------------------------------------------------

def _operands(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 50)) * 10.0 ** rng.uniform(-3, 3, (2, 50))
    b = rng.normal(size=(2, 50)) * 10.0 ** rng.uniform(-3, 3, (2, 50))
    b[1, :5] = 0.0          # exactly real operands: signed-zero paths
    a[1, 5:10] = -0.0
    return a, b


CX_OPS = {
    "add": lambda m, a, b: a + b,
    "radd_real": lambda m, a, b: 2.5 + a,
    "sub": lambda m, a, b: a - b,
    "rsub_real": lambda m, a, b: 1.0 - a,
    "neg": lambda m, a, b: -a,
    "mul": lambda m, a, b: a * b,
    "mul_real": lambda m, a, b: a * b.re,
    "rmul_scalar": lambda m, a, b: 0.25 * a,
    "div": lambda m, a, b: a / b,
    "div_real": lambda m, a, b: a / 3.0,
    "rdiv_real": lambda m, a, b: 1.0 / a,
    "conj": lambda m, a, b: m.conj(a),
    "log": lambda m, a, b: m.log(a),
    "cx_scalar_im": lambda m, a, b: m.cx(a.re, 2.0),
    "cx_real": lambda m, a, b: m.cx(a.re),
    "where": lambda m, a, b: m.where(a.re > 0, a, b),
}


@pytest.mark.parametrize("op", list(CX_OPS))
def test_cx_op_matches_jax(op):
    a, b = _operands(11)
    t = CX_OPS[op](cp, cp.Cx(_t(a[0]), _t(a[1])), cp.Cx(_t(b[0]), _t(b[1])))
    j = CX_OPS[op](jcp, jcp.Cx(jnp.asarray(a[0]), jnp.asarray(a[1])),
                   jcp.Cx(jnp.asarray(b[0]), jnp.asarray(b[1])))
    for got, ref in ((t.re, j.re), (t.im, j.im)):
        got = torch.as_tensor(got).numpy()
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)
        # signed zeros feed atan2 downstream: they must match too
        np.testing.assert_array_equal(np.signbit(got), np.signbit(ref))


@pytest.mark.parametrize("fn", ["cabs", "angle"])
def test_cx_real_valued_matches_jax(fn):
    a, _ = _operands(12)
    got = getattr(cp, fn)(cp.Cx(_t(a[0]), _t(a[1]))).numpy()
    ref = np.asarray(getattr(jcp, fn)(jcp.Cx(jnp.asarray(a[0]),
                                             jnp.asarray(a[1]))))
    np.testing.assert_allclose(got, ref, rtol=1e-15)


def test_cx_scalar_pairs_combine_with_tensors():
    """cx(0, -0.5) is a pair of 0-dim tensors that broadcasts against a
    batch-shaped pair, as the closed forms use it."""
    gr = _t(np.array([[1e-3], [0.2]]))
    z = cp.cx(0.0, -0.5) / cp.cx(gr, 1.0)
    jz = jcp.cx(0.0, -0.5) / jcp.cx(jnp.asarray(gr.numpy()), 1.0)
    np.testing.assert_allclose(_cx_np(z), _jcx_np(jz), rtol=1e-15)
    assert z.re.shape == (2, 1)


# ---------------------------------------------------------------------------
# quadrature
# ---------------------------------------------------------------------------

def test_gl3_2d_matches_jax_and_exact():
    rng = np.random.default_rng(13)
    ay = -_pos(rng, -2, 1, 40)
    by = ay * 0.5

    def f(y, x):
        return (y / x) ** 2 / (y - 1.0) ** 2

    got = quad.gl3_2d(f, _t(ay), _t(by), lambda y: -y,
                      lambda y: -_t(ay)).numpy()
    ref = np.asarray(jquad.gl3_2d(f, jnp.asarray(ay), jnp.asarray(by),
                                  lambda y: -y, lambda y: -jnp.asarray(ay)))
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    # a product of cubics over a rectangle is integrated exactly
    val = float(quad.gl3_2d(lambda y, x: y ** 3 * x ** 2 + x,
                            _t(0.0), _t(2.0), lambda y: 0.0 * y + 1.0,
                            lambda y: 0.0 * y + 3.0))
    exact = (2.0 ** 4 / 4) * (27 - 1) / 3 + 2.0 * (9 - 1) / 2
    assert abs(val - exact) < 1e-12 * exact
