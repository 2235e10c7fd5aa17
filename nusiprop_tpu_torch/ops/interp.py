"""N-dimensional local-cubic spline interpolation (port of
``nusiprop_tpu.ops.interp``).

The reference's ``interp::spline_ND`` (interp.hpp:14-638): a cubic-Hermite
scheme with finite-difference tangents expressed as per-node weight
polynomials over a <=4-node stencil per axis (computeWeights,
interp.hpp:576-636), tensor-multiplied across dimensions (f_eval,
interp.hpp:345-467). The weights are computed on the host with numpy once
per table; evaluation is a torch function of gathered table values, so it
runs over whole batches of query points on any device.

Semantics matched to the reference and the JAX package:
  * per-axis optional log reparametrization of nodes and/or values
    (isLog, interp.hpp:73-76);
  * regular grids use O(1) index arithmetic with the same edge snapping
    (interp.hpp:366-374); irregular grids use searchsorted;
  * the stencil is 3 nodes at the first/last interval and 4 in the
    interior, with the same edge weight formulas;
  * out-of-range queries: the reference calls exit(1)
    (interp.hpp:354-361); here the query is CLAMPED to the valid interval
    and ``out_of_bounds`` tells a caller where the reference would have
    exited (``Config(extrapolation="raise")`` acts on it).
"""

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = ["SplineND", "build_spline", "load_text_table",
           "load_binary_table"]


def _axis_weights(x: np.ndarray) -> np.ndarray:
    """Per-node weight tensor W[offset(4), coef(4), node] for one axis
    (transcription of computeWeights, interp.hpp:580-634; unused edge
    rows are zero so a fixed 4-node gather is safe)."""
    n = x.shape[0]
    W = np.zeros((4, 4, n), dtype=np.float64)
    for j in range(n - 1):
        if j == 0:
            W[0, :, j] = [0.0,
                          (x[j] - x[j + 1]) / (x[j] - x[j + 2]),
                          -1.0 + (x[j + 1] - x[j]) / (x[j] - x[j + 2]),
                          1.0]
            W[1, :, j] = [0.0,
                          (x[j + 1] - x[j]) / (x[j + 1] - x[j + 2]),
                          (x[j] - x[j + 2]) / (x[j + 1] - x[j + 2]),
                          0.0]
            W[2, :, j] = [0.0,
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j + 2] - x[j + 1]) * (x[j + 2] - x[j])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j + 2] - x[j + 1]) * (x[j] - x[j + 2])),
                          0.0]
        elif j == n - 2:
            W[0, :, j] = [0.0,
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j - 1] - x[j]) * (x[j - 1] - x[j + 1])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j] - x[j - 1]) * (x[j - 1] - x[j + 1])),
                          0.0]
            W[1, :, j] = [0.0,
                          (x[j + 1] - x[j]) / (x[j - 1] - x[j]),
                          (2 * x[j] - x[j + 1] - x[j - 1]) / (x[j - 1] - x[j]),
                          1.0]
            W[2, :, j] = [0.0,
                          (x[j] - x[j + 1]) / (x[j - 1] - x[j + 1]),
                          (x[j - 1] - x[j]) / (x[j - 1] - x[j + 1]),
                          0.0]
        else:
            W[0, :, j] = [(x[j + 1] - x[j]) ** 2
                          / ((x[j] - x[j - 1]) * (x[j - 1] - x[j + 1])),
                          2 * (x[j + 1] - x[j]) ** 2
                          / ((x[j - 1] - x[j]) * (x[j - 1] - x[j + 1])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j] - x[j - 1]) * (x[j - 1] - x[j + 1])),
                          0.0]
            W[1, :, j] = [(x[j] - x[j + 1])
                          * (1 / (x[j - 1] - x[j]) + 1 / (x[j] - x[j + 2])),
                          (x[j] - x[j + 1])
                          * (2 / (x[j] - x[j - 1]) + 1 / (x[j + 2] - x[j])),
                          (2 * x[j] - x[j + 1] - x[j - 1]) / (x[j - 1] - x[j]),
                          1.0]
            W[2, :, j] = [(x[j + 1] - x[j])
                          * (1 / (x[j - 1] - x[j + 1])
                             + 1 / (x[j + 1] - x[j + 2])),
                          (x[j + 1] - x[j])
                          * (2 / (x[j + 1] - x[j - 1])
                             + 1 / (x[j + 2] - x[j + 1])),
                          (x[j - 1] - x[j]) / (x[j - 1] - x[j + 1]),
                          0.0]
            W[3, :, j] = [(x[j + 1] - x[j]) ** 2
                          / ((-x[j + 1] + x[j + 2]) * (-x[j] + x[j + 2])),
                          (x[j + 1] - x[j]) ** 2
                          / ((x[j + 1] - x[j + 2]) * (-x[j] + x[j + 2])),
                          0.0,
                          0.0]
    return W


@dataclasses.dataclass(frozen=True)
class SplineND:
    """Interpolation table as tensors on one device.

    ``nodes``/``weights`` are per-axis float64 tensors (already
    log-reparametrized where requested); ``values`` is the full N-D value
    tensor (log-transformed if log_value). ``regular``/``log_axes``/
    ``log_value`` are plain Python values.
    """

    nodes: tuple          # per axis: (n_i,) float64
    weights: tuple        # per axis: (4, 4, n_i) float64
    values: torch.Tensor  # (n_0, ..., n_{N-1})
    regular: bool
    log_axes: tuple       # per axis: bool
    log_value: bool

    @property
    def ndim(self):
        return len(self.nodes)

    @property
    def device(self):
        return self.values.device

    def to(self, device):
        """Copy on ``device`` (the same object where it is there already)."""
        device = torch.device(device)
        here = self.values.device
        if here.type == device.type and device.index in (None, here.index):
            return self
        mv = lambda t: t.to(device)
        return dataclasses.replace(
            self, nodes=tuple(map(mv, self.nodes)),
            weights=tuple(map(mv, self.weights)), values=mv(self.values))

    def astype(self, dtype):
        """Copy with ``values`` cast to ``dtype``. ``eval`` contracts the
        stencil in the values dtype, so ``astype(torch.float32)`` makes a
        float32 interpolator; nodes and weight polynomials stay float64
        (O(4N) per query against the contraction's O(4^N))."""
        return dataclasses.replace(self, values=self.values.to(dtype))

    def _coords(self, i, coords):
        c = torch.as_tensor(coords, dtype=torch.float64, device=self.device)
        if self.log_axes[i]:
            c = torch.log(torch.clamp(c, min=1e-300))
        return c

    def axis_index_weights(self, i, coords):
        """Stencil base index and 4-node polynomial weights along axis
        ``i`` at raw (pre-log) coordinates: ``(base, p)`` with ``base`` of
        ``coords``' shape and ``p`` of shape ``(4,) + coords.shape``
        (float64), so that ``f = sum_o p[o] * values[..., base + o, ...]``
        along this axis. ``eval`` calls it; callers whose queries form a
        separable grid contract axis by axis with it (kernels.py)."""
        x = self.nodes[i]
        c = torch.clamp(self._coords(i, coords), min=x[0], max=x[-1])
        n = x.shape[0]
        if self.regular:
            k = torch.floor((c - x[0]) / (x[1] - x[0])).to(torch.int64)
            # same edge snapping as interp.hpp:369-373
            k = torch.where(c < x[1], 0, k)
            k = torch.where(c > x[n - 2], n - 2, k)
        else:
            k = torch.clamp(torch.searchsorted(x, c.contiguous(), right=True)
                            - 1, 0, n - 2)
        t = (c - x[k]) / (x[k + 1] - x[k])
        W = self.weights[i][:, :, k]                       # (4, 4, ...)
        p = ((W[:, 0] * t + W[:, 1]) * t + W[:, 2]) * t + W[:, 3]
        # idx_min (interp.hpp:394-404): k at the left edge, else k-1; the
        # 4th stencil row is zero at the edges, so the clamped index below
        # meets a zero weight
        base = torch.where(k == 0, k, k - 1)
        return base, p

    def eval(self, *coords):
        """Interpolate at broadcastable coordinates (one per axis),
        clamped to the valid interval. The polynomial weights are cast to
        the values dtype and the 4^N stencil is summed in its flat order
        (axis 0 fastest), as in the JAX package."""
        coords = torch.broadcast_tensors(
            *(torch.as_tensor(c, dtype=torch.float64, device=self.device)
              for c in coords))
        polys, bases = [], []
        for i in range(self.ndim):
            base, p = self.axis_index_weights(i, coords[i])
            polys.append(p.to(self.values.dtype))          # (4, ...)
            bases.append(base)
        res = 0.0
        for flat in range(4 ** self.ndim):
            idx = []
            w = 1.0
            rem = flat
            for i in range(self.ndim):
                o = rem % 4
                rem //= 4
                n_i = self.nodes[i].shape[0]
                idx.append(torch.clamp(bases[i] + o, max=n_i - 1))
                w = w * polys[i][o]
            res = res + w * self.values[tuple(idx)]
        return torch.exp(res) if self.log_value else res

    def out_of_bounds(self, *coords):
        """True where the reference would exit(1) (interp.hpp:354-361)."""
        coords = [torch.as_tensor(c, dtype=torch.float64, device=self.device)
                  for c in coords]
        oob = torch.zeros(torch.broadcast_shapes(*(c.shape for c in coords)),
                          dtype=torch.bool, device=self.device)
        for i in range(self.ndim):
            x = self.nodes[i]
            c = self._coords(i, coords[i])
            oob = oob | (c <= x[0]) | (c >= x[-1])
        return oob


def build_spline(nodes: Sequence[np.ndarray], values: np.ndarray,
                 regular: bool = False, log_axes: Sequence[bool] = None,
                 log_value: bool = False, device="cpu") -> SplineND:
    """Build a SplineND from host arrays (cf. interp.hpp ctor :80-133),
    its tensors on ``device``."""
    ndim = len(nodes)
    if log_axes is None:
        log_axes = (False,) * ndim
    xs = []
    for i, x in enumerate(nodes):
        x = np.asarray(x, dtype=np.float64)
        xs.append(np.log(x) if log_axes[i] else x)
    vals = np.asarray(values, dtype=np.float64)
    assert vals.shape == tuple(len(x) for x in xs)
    if log_value:
        vals = np.log(vals)
    t = lambda a: torch.as_tensor(a, device=torch.device(device))
    return SplineND(
        nodes=tuple(t(x) for x in xs),
        weights=tuple(t(_axis_weights(x)) for x in xs),
        values=t(vals),
        regular=bool(regular),
        log_axes=tuple(bool(b) for b in log_axes),
        log_value=bool(log_value),
    )


def _rows_to_spline(path, raw, shape, regular, log_axes, log_value, device):
    ndim = len(shape)
    n_rows = int(np.prod(shape))
    if raw.shape[0] != n_rows:
        raise ValueError(
            f"{path}: expected {n_rows} rows for shape {shape}, "
            f"got {raw.shape[0]}")
    values = raw[:, -1].astype(np.float64).reshape(shape)
    nodes = []
    for i in range(ndim):
        stride = int(np.prod(shape[i + 1:]))
        nodes.append(raw[::stride, i][:shape[i]].astype(np.float64))
    return build_spline(nodes, values, regular=regular, log_axes=log_axes,
                        log_value=log_value, device=device)


def load_text_table(path: str, shape: Sequence[int], regular: bool = True,
                    log_axes: Sequence[bool] = None, log_value: bool = False,
                    device="cpu") -> SplineND:
    """Load a reference-format text table (whitespace-separated rows of
    x_0 ... x_{N-1} f, '#' comment lines skipped, last axis fastest;
    interp.hpp:173-247) and build the interpolator."""
    shape = tuple(int(s) for s in shape)
    raw = np.loadtxt(path, dtype=np.float64, comments="#")
    return _rows_to_spline(path, raw.reshape(-1, len(shape) + 1), shape,
                           regular, log_axes, log_value, device)


def load_binary_table(path: str, shape: Sequence[int], regular: bool = True,
                      log_axes: Sequence[bool] = None,
                      log_value: bool = False, device="cpu") -> SplineND:
    """Load a reference-format binary table (float32 rows of
    x_0 ... x_{N-1} f, last axis fastest; interp.hpp:253-292 /
    text_to_binary.cpp) and build the interpolator."""
    shape = tuple(int(s) for s in shape)
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, len(shape) + 1)
    return _rows_to_spline(path, raw, shape, regular, log_axes, log_value,
                           device)
