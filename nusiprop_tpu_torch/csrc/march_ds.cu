// The s-channel (rank1) fused march for NVIDIA Hopper (sm_90a), native fp64.
//
// Replaces the Pallas TPU kernel nusiprop_tpu/ops/march_ds.py::_make_kernel
// (body _march_body, launched by march_pallas_batched). It computes what
// that kernel computes -- the whole redshift march of one parameter point
// -- in float64, where the TPU kernel had to emulate it with double-single
// float32 pairs (Mosaic has no f64):
//
// * One thread block per parameter point; the loop over the Nz-1 z-nodes
//   runs inside the block in place of the TPU's sequential loop, and
//   nothing carries across blocks. The bins are not padded (the TPU rows
//   are padded to 128 lanes); DW depends on the grid only and is one
//   (Nz-1, NE) row that every block reads.
// * Thread tid owns bins j = tid + k*blockDim (k < K, a template constant
//   chosen by the launcher), so any bin count runs with at most 512
//   threads. Per node each thread loads its bins' six rows (coalesced:
//   neighbouring threads read neighbouring bins), and in registers
//   computes, in _march_body's order: izdr_k, m_k, M, its adjugate and
//   det; V and U through the adjugate solve; U.w, V.w, a and b.
// * The affine recurrence cum_{j+1} = a_j cum_j + b_j over the bins in
//   processing order is the Hillis-Steele inclusive prefix of the maps
//   (a, b) in shared memory, double buffered: per level of distance d,
//   (a, b)_j <- (a_j a_{j-d}, a_j b_{j-d} + b_j), one barrier per level.
//   That is the composition order of the plain twin (march_ds_plain), so
//   the two agree to the last bit. Then cum_j = B_inc[j-1] (exclusive) and
//   flux_k = V_k + (cum DW) U_k, kept in registers for the next node.
// * Output: flux (B, 3, NE) fp64 in processing order, written once.
//
// What bounds it on this card: the bytes. Each point reads its five rows
// once, 5 * (Nz-1) * NE * 8 B (1.6 GB at batch 1024, NE 500, with the
// shared DW row), against ~150 fp64 operations per bin and node (about
// 0.18 ms of the 34 TFLOP/s fp64 rate at that shape vs 0.48 ms of the
// 3.35 TB/s HBM rate). The dependency chain is short: (Nz-1) nodes x
// (log2(NE) + 2) barriers.
// Prefetching the next node's rows (TMA or cp.async) during the scan and
// marching several points per block at small batch are later work.
// Shared memory is 4 doubles per bin, so NE <= 7264 (232,448 B).
//
// Arithmetic: built with --fmad=false so every multiply and add rounds as
// the plain PyTorch twin's separate tensor operations do.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

struct Rows {
  const double *pg, *pat, *pl, *co, *cw, *dw;
};

// The per-bin algebra of one node (_march_body up to a and b).
__device__ __forceinline__ void node(const Rows& r, size_t i, double DW,
                                     const double f[3], const double W[3],
                                     const double W2[3], double V[3],
                                     double U[3], double& a, double& b) {
  const double PG = r.pg[i], PAt = r.pat[i], PL = r.pl[i], CO = r.co[i];
  const double CW = r.cw[i];
  double izdr[3], m[3];
  for (int k = 0; k < 3; ++k) {
    izdr[k] = 1.0 / (1.0 + (PG * W[k] - PAt * W2[k]));
    m[k] = (CO * W[k]) * izdr[k];
  }
  double M[3][3];
  for (int k = 0; k < 3; ++k)
    for (int l = 0; l < 3; ++l) M[k][l] = (k == l) ? 1.0 : m[k] * W[l];
  double A[3][3];
  A[0][0] = M[1][1] * M[2][2] - M[1][2] * M[2][1];
  A[0][1] = M[0][2] * M[2][1] - M[0][1] * M[2][2];
  A[0][2] = M[0][1] * M[1][2] - M[0][2] * M[1][1];
  A[1][0] = M[1][2] * M[2][0] - M[1][0] * M[2][2];
  A[1][1] = M[0][0] * M[2][2] - M[0][2] * M[2][0];
  A[1][2] = M[0][2] * M[1][0] - M[0][0] * M[1][2];
  A[2][0] = M[1][0] * M[2][1] - M[1][1] * M[2][0];
  A[2][1] = M[0][1] * M[2][0] - M[0][0] * M[2][1];
  A[2][2] = M[0][0] * M[1][1] - M[0][1] * M[1][0];
  const double det =
      (M[0][0] * A[0][0] + M[0][1] * A[1][0]) + M[0][2] * A[2][0];
  const double idet = 1.0 / det;
  double rv[3], ru[3];
  for (int k = 0; k < 3; ++k) {
    rv[k] = (f[k] + PL) * izdr[k];
    ru[k] = izdr[k] * W[k];
  }
  for (int k = 0; k < 3; ++k) {
    V[k] = ((A[k][0] * rv[0] + A[k][1] * rv[1]) + A[k][2] * rv[2]) * idet;
    U[k] = ((A[k][0] * ru[0] + A[k][1] * ru[1]) + A[k][2] * ru[2]) * idet;
  }
  const double uw = (U[0] * W[0] + U[1] * W[1]) + U[2] * W[2];
  const double vw = (V[0] * W[0] + V[1] * W[1]) + V[2] * W[2];
  a = 1.0 + (CW * DW) * uw;
  b = CW * vw;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
march_ds_kernel(Rows rows, double* __restrict__ out, int n_steps, int NE,
                double w0, double w1, double w2) {
  extern __shared__ double smem[];
  double* sa[2] = {smem, smem + NE};
  double* sb[2] = {smem + 2 * NE, smem + 3 * NE};

  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const double W[3] = {w0, w1, w2};
  const double W2[3] = {w0 * w0, w1 * w1, w2 * w2};
  const size_t base = (size_t)blockIdx.x * n_steps * NE;

  double f[K][3];
  for (int k = 0; k < K; ++k)
    for (int c = 0; c < 3; ++c) f[k][c] = 0.0;

  for (int t = 0; t < n_steps; ++t) {
    const size_t db = (size_t)t * NE;  // the shared DW row of node t
    const size_t rb = base + db;
    double V[K][3], U[K][3], dw[K];
    // the previous node's read-out of the scan buffers is complete
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * T;
      if (j < NE) {
        double a, b;
        dw[k] = rows.dw[db + j];
        node(rows, rb + j, dw[k], f[k], W, W2, V[k], U[k], a, b);
        sa[0][j] = a;
        sb[0][j] = b;
      }
    }
    __syncthreads();

    int src = 0;
    for (int d = 1; d < NE; d <<= 1) {
      for (int k = 0; k < K; ++k) {
        const int j = tid + k * T;
        if (j < NE) {
          const double a = sa[src][j], b = sb[src][j];
          if (j >= d) {
            sb[src ^ 1][j] = a * sb[src][j - d] + b;
            sa[src ^ 1][j] = a * sa[src][j - d];
          } else {  // composed with the identity map (1, 0)
            sb[src ^ 1][j] = b;
            sa[src ^ 1][j] = a;
          }
        }
      }
      __syncthreads();
      src ^= 1;
    }

    for (int k = 0; k < K; ++k) {
      const int j = tid + k * T;
      if (j < NE) {
        const double cd = (j > 0 ? sb[src][j - 1] : 0.0) * dw[k];
        for (int c = 0; c < 3; ++c) f[k][c] = V[k][c] + cd * U[k][c];
      }
    }
  }

  for (int k = 0; k < K; ++k) {
    const int j = tid + k * T;
    if (j < NE)
      for (int c = 0; c < 3; ++c)
        out[((size_t)blockIdx.x * 3 + c) * NE + j] = f[k][c];
  }
}

template <int K>
int launch(const Rows& rows, double* out, int B, int n_steps, int NE,
           double w0, double w1, double w2, cudaStream_t stream) {
  const size_t smem = (size_t)4 * NE * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      march_ds_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((NE + K - 1) / K + 31) / 32 * 32;
  march_ds_kernel<K><<<B, threads, smem, stream>>>(rows, out, n_steps, NE,
                                                   w0, w1, w2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the march on `stream`. The rows, in prepare_rank1_inputs order
// and processing order: PG, PAt, PL, CO, CW (B, n_steps, NE) fp64 each and
// DW (n_steps, NE), shared by all points; out: (B, 3, NE). Returns the
// cudaError_t of the launch (0 on success).
int march_ds_launch(const double* pg, const double* pat, const double* pl,
                    const double* co, const double* cw, const double* dw,
                    double* out, int B, int n_steps, int NE, double w0,
                    double w1, double w2, void* stream) {
  const Rows rows{pg, pat, pl, co, cw, dw};
  const cudaStream_t s = (cudaStream_t)stream;
  if (NE <= kMaxThreads)
    return launch<1>(rows, out, B, n_steps, NE, w0, w1, w2, s);
  if (NE <= 2 * kMaxThreads)
    return launch<2>(rows, out, B, n_steps, NE, w0, w1, w2, s);
  if (NE <= 4 * kMaxThreads)
    return launch<4>(rows, out, B, n_steps, NE, w0, w1, w2, s);
  if (NE <= 8 * kMaxThreads)
    return launch<8>(rows, out, B, n_steps, NE, w0, w1, w2, s);
  return launch<16>(rows, out, B, n_steps, NE, w0, w1, w2, s);
}

const char* march_ds_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
