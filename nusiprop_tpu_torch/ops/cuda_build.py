"""Build the port's hand-written CUDA kernels and bind them through ctypes.

Each kernel source ``csrc/<name>.cu`` exposes a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` at first use into
``nusiprop_tpu_torch/_build/lib<name>_<hash>.so``, where the hash covers
the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. ``build`` starts one ``nvcc`` per stale library,
all at once, and waits for them together. Nothing here runs at import.

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch twins beside each kernel round them.

The kernels are forward-only, as the Pallas marches of the JAX package
are: a launch on ``data_ptr()`` records nothing for autograd, so
``refuse_grad`` stops a launch whose result would be cut from the graph,
and ``traced`` tells a dispatcher to take the plain twin instead.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch
from torch._C._functorch import maybe_current_level
from torch.autograd import forward_ad

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# kernel name -> nvcc's output (ptxas register/smem report) of the build
# made by this process; empty for a library found already built
BUILD_LOG = {}
_LIBS = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return path


def _library_path(name: str) -> str:
    """Where the library of kernel ``name`` is (or will be) built."""
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(*names) -> dict:
    """Compile the named kernels whose library is missing, one ``nvcc``
    each, all started together; returns {name: library path}. Raises
    with nvcc's output if any build fails."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    try:
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(_CSRC, n + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs[n] = (proc, tmp)
        failed = []
        for n, (proc, tmp) in jobs.items():
            BUILD_LOG[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n} ({proc.returncode}):\n"
                              f"{BUILD_LOG[n]}")
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def load(name: str, declare):
    """The ctypes library of kernel ``name``, built if needed and loaded
    once per process; ``declare(lib)`` sets its functions' argtypes and
    restypes on first load."""
    if name not in _LIBS:
        lib = ctypes.CDLL(build(name)[name])
        declare(lib)
        _LIBS[name] = lib
    return _LIBS[name]


def refuse_grad(kernel: str, tensors):
    """Raise ``RuntimeError`` before a launch of ``kernel`` where grad mode
    is on and an input requires grad: the kernel's output would carry no
    gradient, and a caller differentiating through it would get one that
    is silently missing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the fused {kernel} kernel march is forward-only (as the Pallas "
            "marches of the JAX package are): its flux would be cut from "
            "the autograd graph. Differentiate through "
            "nusiprop_tpu_torch.fit/fisher, march='trisolve' or 'loop' "
            "(the float64 eager marches), or CPU tensors; run the forward "
            "flux under torch.no_grad()")


def traced(*xs) -> bool:
    """True where a derivative or a batch of any tensor among ``xs`` may
    be traced: inside a ``torch.func`` transform (``jvp``, ``vmap``,
    ``grad``; there every result is wrapped, a constant's too, and has no
    storage), on a forward-AD dual, or in grad mode on a tensor that
    requires grad. A launch on ``data_ptr()`` would drop it, so the
    dispatchers take the plain twin there. Non-tensors are skipped."""
    if maybe_current_level() is not None:
        return True
    ts = [x for x in xs if torch.is_tensor(x)]
    return (any(forward_ad.unpack_dual(t).tangent is not None for t in ts)
            or (torch.is_grad_enabled() and any(t.requires_grad
                                                for t in ts)))
