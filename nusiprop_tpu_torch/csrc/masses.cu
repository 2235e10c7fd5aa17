// The neutrino mass spectrum from the total mass, for NVIDIA Hopper
// (sm_90a), fp64: the whole of models/masses.py::mass_spectrum_plain in one
// launch.
//
// The JAX package has no TPU kernel here: its nusiprop_tpu/models/masses.py
// is XLA elementwise code, and the port's plain twin runs the same
// 200-step bisection as 13 tensor operations a step, ~2,600 launches of a
// few fp64 operations each. This kernel gives each element of mntot one
// thread, which runs in registers, in the twin's order:
//
// * the bisection of lightest_mass on [0, mntot]: mid = 0.5 * (lo + hi);
//   the constraint sum (mid + sqrt(mid*mid + dm21)) + sqrt(mid*mid + |dm_at|)
//   (normal ordering) or (mid + sqrt(mid*mid + |dm_at|))
//   + sqrt((mid*mid + |dm_at|) - dm21) (inverted); the compare with mntot
//   and the two selects; then mL = 0.5 * (lo + hi);
// * the three eigenvalues: NO [mL, sqrt(dm21 + mL*mL), sqrt(dm_at + mL*mL)],
//   IO m2 = sqrt(mL*mL - dm_at), [sqrt(m2*m2 - dm21), m2, mL];
// * the floor, as torch.clamp(min=floor) takes it (NaN passes through).
//
// Every multiply and add is its own IEEE round-to-nearest operation
// (--fmad=false) and the square root is __dsqrt_rn, so each step rounds as
// the twin's separate tensor operations round: the spectrum is bitwise the
// twin's. Output: out[3 i + k], fp64, contiguous (mntot.shape + (3,)).
//
// What bounds it: neither the bytes (32 B an element) nor the arithmetic
// (~12 fp64 operations and two square roots a step): the step chain is
// serial, so an element takes 200 dependent steps whatever the card, a few
// tens of microseconds. The launch replaces ~2,600.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The constraint sum at mL, rounded as the twin's lightest_mass.total.
__device__ __forceinline__ double total(double mL, double dm21, double at,
                                        bool normal) {
  const double m2 = mL * mL;
  if (normal) return (mL + __dsqrt_rn(m2 + dm21)) + __dsqrt_rn(m2 + at);
  const double s = m2 + at;
  return (mL + __dsqrt_rn(s)) + __dsqrt_rn(s - dm21);
}

__device__ __forceinline__ double floor_at(double v, double mn_floor) {
  return isnan(v) ? v : (v < mn_floor ? mn_floor : v);
}

__global__ void __launch_bounds__(kThreads)
    masses_kernel(const double* __restrict__ mntot, double* __restrict__ out,
                  long long n, bool normal, double dm21, double dm_at,
                  double mn_floor, int n_bisect) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const double m = mntot[i];
  const double at = fabs(dm_at);
  double lo = 0.0, hi = m;
  for (int k = 0; k < n_bisect; ++k) {
    const double mid = 0.5 * (lo + hi);
    const bool right = total(mid, dm21, at, normal) < m;
    lo = right ? mid : lo;
    hi = right ? hi : mid;
  }
  const double mL = 0.5 * (lo + hi);
  double m1, m2, m3;
  if (normal) {
    m1 = mL;
    m2 = __dsqrt_rn(dm21 + mL * mL);
    m3 = __dsqrt_rn(dm_at + mL * mL);
  } else {
    m2 = __dsqrt_rn(mL * mL - dm_at);
    m1 = __dsqrt_rn(m2 * m2 - dm21);
    m3 = mL;
  }
  out[3 * i] = floor_at(m1, mn_floor);
  out[3 * i + 1] = floor_at(m2, mn_floor);
  out[3 * i + 2] = floor_at(m3, mn_floor);
}

}  // namespace

extern "C" {

// Launch the spectrum of n total masses (fp64, contiguous) into out (n, 3)
// on `stream`. normal: 1 for normal ordering (dm_at = dm31 > 0), 0 for
// inverted (dm_at = dm32 < 0). Returns the cudaError_t of the launch.
int masses_launch(const double* mntot, double* out, long long n, int normal,
                  double dm21, double dm_at, double mn_floor, int n_bisect,
                  void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  masses_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      mntot, out, n, normal != 0, dm21, dm_at, mn_floor, n_bisect);
  return (int)cudaGetLastError();
}

const char* masses_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
