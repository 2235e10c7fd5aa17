// The non-resonant fused trisolve march for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nusiprop_tpu/ops/march_tri.py::_make_kernel
// (launched by _pallas_march). It computes what that kernel computes — the
// whole redshift march of one parameter point — but is designed for the
// card, not carried over block by block:
//
// * One thread block per parameter point. The loop over the Nz-1 z-nodes
//   runs inside the block and takes the place of the TPU's sequential `t`
//   grid axis; nothing carries across blocks.
// * Per node, each thread computes the Sherman-Morrison reduction
//   (sm_node, the JAX _sm_node) for the bins it owns (j = tid + k*blockDim) and stores
//   c1 = CS*qv, c2 = CS*pu in shared memory.
// * Then the descending back-substitution over j:
//       p_j = sum_m A[off+j, m] * cy[m],   cy[off+j] = c1_j + c2_j * p_j.
//   The table is strictly upper triangular and cy is zero outside the
//   window, so the dot runs over the live columns off+j+1 .. off+NE-1 only
//   (the TPU kernel multiplies through all NXP lanes). Rows are read from
//   global memory / L2; cy (NEXT floats) lives in shared memory. Each
//   column m is owned by thread m % blockDim: the owner is the only thread
//   that ever writes or reads cy[m], so cy needs no barrier, and every
//   step costs exactly one __syncthreads (the block reduction, double
//   buffered by step parity).
// * phi (3 x NE) is carried in shared memory between nodes; the output is
//   written at the last node only.
// * No bin ceiling: shared memory is (NEXT + 6*NE) floats, O(NEXT) and not
//   O(NEXT^2) like the TPU kernel's (NEXT, 8, NXP) VMEM scratch. Above
//   48 KB the launcher raises the dynamic shared-memory limit.
//
// What bounds it on this card: the latency of NE sequential block
// reductions per node, Nz-1 nodes deep (each step is a dependent chain of
// global loads, a warp-shuffle reduction and a barrier). The bytes are not
// the bound: ~NE^2/2 * 4 B per node per point, ~5 GB in all at batch 128 /
// NE 500, is a few ms of HBM bandwidth. Prefetching the next row during
// the reduction, wgmma/TMA, and designs that march several points per
// block (to fill the card at small batch) are later work.
//
// Arithmetic: built with --fmad=false so every elementwise step rounds as
// the plain PyTorch twin (ops/march_tri.py::march_tri_plain) does; the only
// difference from the twin is the f32 summation order of the row dot.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Rows {
  const float *pg, *pat, *co, *r0, *s0, *cs, *pt;
};

// The Sherman-Morrison algebra of one bin (_sm_node), in its association
// order. Both passes of a node recompute it from the rows and the carry,
// so shared memory stays O(NEXT) instead of holding U and V.
struct SmNode {
  float w_d[3], rv_d[3];
  float wu, inv_s, wv;
};

__device__ __forceinline__ SmNode sm_node(const Rows& rows, size_t i,
                                          const float* phi, int NE,
                                          const float W[3],
                                          const float W2[3]) {
  const float PG = rows.pg[i], PAt = rows.pat[i], CO = rows.co[i];
  const float R0 = rows.r0[i], S0 = rows.s0[i];
  SmNode n;
  for (int k = 0; k < 3; ++k) {
    const float d = 1.0f + PG * W[k] - (PAt + CO) * W2[k];
    n.w_d[k] = W[k] / d;
    n.rv_d[k] = (phi[k * NE] * R0 + S0) / d;
  }
  n.wu = n.w_d[0] * W[0] + n.w_d[1] * W[1] + n.w_d[2] * W[2];
  n.inv_s = 1.0f / (1.0f + CO * n.wu);
  n.wv = W[0] * n.rv_d[0] + W[1] * n.rv_d[1] + W[2] * n.rv_d[2];
  return n;
}

__global__ void __launch_bounds__(kThreads)
march_tri_kernel(const float* __restrict__ A, Rows rows,
                 float* __restrict__ out, int NE, int Nz, int NEXT,
                 float w0, float w1, float w2) {
  extern __shared__ float smem[];
  float* cy = smem;                // NEXT
  float* phi = cy + NEXT;          // 3 * NE
  float* c1 = phi + 3 * NE;        // NE
  float* c2 = c1 + NE;             // NE
  float* pv = c2 + NE;             // NE
  __shared__ float red[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int Ns = Nz - 1;
  const float* Ab = A + (size_t)b * NEXT * NEXT;
  const size_t row_base = (size_t)b * Ns * NE;
  const float W[3] = {w0, w1, w2};
  const float W2[3] = {w0 * w0, w1 * w1, w2 * w2};

  for (int j = tid; j < 3 * NE; j += kThreads) phi[j] = 0.0f;
  int step = 0;

  for (int t = 0; t < Ns; ++t) {
    const int off = Nz - 2 - t;
    const size_t rb = row_base + (size_t)t * NE;
    // the previous node's last step still reads c1/c2 in other threads
    __syncthreads();

    // ---- Sherman-Morrison per bin (owner thread j % kThreads) ----
    for (int j = tid; j < NE; j += kThreads) {
      const SmNode n = sm_node(rows, rb + j, phi + j, NE, W, W2);
      const float CS = rows.cs[rb + j];
      c1[j] = CS * (n.wv * n.inv_s);
      c2[j] = CS * (rows.pt[rb + j] * (n.wu * n.inv_s));
    }
    __syncthreads();

    // ---- descending back-substitution over the window ----
    const int hi = off + NE;  // one past the last live column
    for (int j = NE - 1; j >= 0; --j, ++step) {
      const int r = off + j;
      const float* Arow = Ab + (size_t)r * NEXT;
      // first column > r owned by this thread (m % kThreads == tid)
      int m = r + 1 + ((tid - (r + 1)) % kThreads + kThreads) % kThreads;
      float part = 0.0f;
      for (; m < hi; m += kThreads) part += Arow[m] * cy[m];
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      float* rd = red[step & 1];
      if (lane == 0) rd[warp] = part;
      __syncthreads();
      float p = rd[0];
      for (int k = 1; k < kWarps; ++k) p += rd[k];
      if (r % kThreads == tid) cy[r] = c1[j] + c2[j] * p;
      if (j % kThreads == tid) pv[j] = p;
    }
    // pv[j] and phi[.][j] are owned by thread j % kThreads: no barrier

    // ---- x_k = V_k + PT * p * U_k, recomputed per owned bin ----
    const bool last = (t == Ns - 1);
    for (int j = tid; j < NE; j += kThreads) {
      const SmNode n = sm_node(rows, rb + j, phi + j, NE, W, W2);
      const float cws = (rows.co[rb + j] * n.wv) * n.inv_s;
      const float reg = rows.pt[rb + j] * pv[j];
      for (int k = 0; k < 3; ++k) {
        const float V = n.rv_d[k] - cws * n.w_d[k];
        const float U = n.w_d[k] * n.inv_s;
        const float x = V + reg * U;
        phi[k * NE + j] = x;
        if (last) out[((size_t)b * 3 + k) * NE + j] = x;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch the march on `stream`. A: (B, NEXT, NEXT) f32; the seven rows:
// (B, Nz-1, NE) f32 each, in _trisolve_f32_rows order; out: (B, 3, NE).
// Returns the cudaError_t of the launch (0 on success).
int march_tri_launch(const float* A, const float* pg, const float* pat,
                     const float* co, const float* r0, const float* s0,
                     const float* cs, const float* pt, float* out, int B,
                     int NE, int Nz, int NEXT, float w0, float w1, float w2,
                     void* stream) {
  const size_t smem = (size_t)(NEXT + 6 * NE) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      march_tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Rows rows{pg, pat, co, r0, s0, cs, pt};
  march_tri_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, rows, out, NE, Nz, NEXT, w0, w1, w2);
  return (int)cudaGetLastError();
}

const char* march_tri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
