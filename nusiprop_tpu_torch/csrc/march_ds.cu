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
// * Thread tid owns the K consecutive bins j = tid*K + k (k < K, a
//   template constant chosen by the launcher: the least power of two with
//   NE <= K * kThreads). Per node it computes for each of its bins, in
//   registers and in _march_body's order: izdr_k, m_k, M, its adjugate and
//   det; V and U through the adjugate solve; U.w, V.w, a and b.
// * The affine recurrence cum_{j+1} = a_j cum_j + b_j over the bins in
//   processing order is a hierarchical scan of the maps (a, b) with ONE
//   block barrier per node and no pass through shared memory per level:
//     1. a thread composes its K maps serially in registers;
//     2. a warp scans its 32 thread maps with five __shfl_up_sync levels
//        (a lane below the level's distance composes with the identity
//        map (1, 0), by a select and not a branch);
//     3. lane 31 writes the warp's total map to shared memory, into the
//        buffer of this node's parity; the barrier; every warp reads the
//        <= 16 totals, scans them with shuffles and takes the inclusive
//        total of the warps before it (the state entering the warp);
//     4. the state entering a thread is its warp-exclusive map (one more
//        __shfl_up_sync; lane 0 takes the identity) applied to that, and
//        the thread walks its K bins: flux_k = V_k + (cum DW) U_k, then
//        cum <- a cum + b.
//   The totals buffer of parity p is written again two nodes later, after
//   the barrier of the node between, which every warp reaches only when
//   its reads are over: no second barrier guards the reuse.
//   K consecutive bins per thread (and not bins strided over the block)
//   so that one warp scan and one barrier serve all K bins of a thread:
//   the shuffles are per thread, so their cost per bin falls with K.
// * The next node's rows (PG, PAt, PL, CO, CW of node t+1 and DW's row
//   t+1) are loaded into registers before node t's algebra and scan and
//   are first used after them: the global round trip hides behind a
//   node's work. Registers and not a shared-memory stage: at K = 2 the 24
//   registers fit under the 128 that two resident blocks of 256 threads
//   allow, and a stage would add a wait and nothing else.
// * Dead bins (j >= NE, in the last threads only) load zero rows, which
//   make exactly a = 1, b = 0, flux 0: the identity map, with no branch
//   around a shuffle. They follow every live bin in processing order.
// * Output: flux (B, 3, NE) fp64 in processing order, written once.
//
// The composition order is not the plain twin's (march_ds_plain composes
// by Hillis-Steele doubling over all bins), so the two agree to fp64
// round-off, not to the last bit.
//
// What bounds it on this card: the bytes. Each point reads its five rows
// once, 5 * (Nz-1) * NE * 8 B (1.6 GB at batch 1024, NE 500, with the
// shared DW row: 0.48 ms of the 3.35 TB/s HBM rate), against ~145 counted
// fp64 operations per bin and node (0.17 ms of the 34 TFLOP/s rate). That
// rate counts a fused multiply-add as two; here every multiply and add is
// its own instruction (--fmad=false) and each of the four divisions
// expands to some 15-20: about 210 fp64 instructions per bin and node, or
// ~0.5 ms of the fp64 pipes at that shape. So bytes and arithmetic are
// near each other, and the design keeps several independent blocks on an
// SM (256 threads, two or more resident: march_ds_config reads the
// residency from the occupancy calculator) so that one block's barrier
// and shuffles overlap another's arithmetic.
//
// Shared memory: 512 B (two parities x 16 warp totals x (a, b)), whatever
// NE. The bin ceiling is K <= 16 bins on each of kWideThreads = 512
// threads: NE <= 8192. Above K = 2 the registers of a thread's bins
// (about 40 per bin) outgrow the file and ptxas spills; those shapes run
// right, not fast.
//
// Arithmetic: built with --fmad=false so every multiply and add rounds as
// the plain PyTorch twin's separate tensor operations do.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // threads of a block, K <= 8
constexpr int kMinBlocks = 2;      // resident blocks asked of ptxas, K <= 2
constexpr int kWideThreads = 512;  // threads of a block, K = 16
constexpr int kMaxWarps = kWideThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const double *pg, *pat, *pl, *co, *cw, *dw;
};

// One bin's row entries at one node.
struct Bin {
  double pg, pat, pl, co, cw, dw;
};

// The rows of a thread's K bins at one node (zero for a dead bin).
template <int K>
__device__ __forceinline__ void load_bins(const Rows& r, size_t row,
                                          size_t drow, int j0, int NE,
                                          Bin (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    const bool live = j < NE;
    x[k].pg = live ? __ldg(r.pg + row + j) : 0.0;
    x[k].pat = live ? __ldg(r.pat + row + j) : 0.0;
    x[k].pl = live ? __ldg(r.pl + row + j) : 0.0;
    x[k].co = live ? __ldg(r.co + row + j) : 0.0;
    x[k].cw = live ? __ldg(r.cw + row + j) : 0.0;
    x[k].dw = live ? __ldg(r.dw + drow + j) : 0.0;
  }
}

// The per-bin algebra of one node (_march_body up to a and b).
__device__ __forceinline__ void node(const Bin& x, const double f[3],
                                     const double W[3], const double W2[3],
                                     double V[3], double U[3], double& a,
                                     double& b) {
  double izdr[3], m[3];
  for (int k = 0; k < 3; ++k) {
    izdr[k] = 1.0 / (1.0 + (x.pg * W[k] - x.pat * W2[k]));
    m[k] = (x.co * W[k]) * izdr[k];
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
    rv[k] = (f[k] + x.pl) * izdr[k];
    ru[k] = izdr[k] * W[k];
  }
  for (int k = 0; k < 3; ++k) {
    V[k] = ((A[k][0] * rv[0] + A[k][1] * rv[1]) + A[k][2] * rv[2]) * idet;
    U[k] = ((A[k][0] * ru[0] + A[k][1] * ru[1]) + A[k][2] * ru[2]) * idet;
  }
  const double uw = (U[0] * W[0] + U[1] * W[1]) + U[2] * W[2];
  const double vw = (V[0] * W[0] + V[1] * W[1]) + V[2] * W[2];
  a = 1.0 + (x.cw * x.dw) * uw;
  b = x.cw * vw;
}

// Inclusive scan of one affine map (a, b) per lane over the lanes below
// `width` distance levels: (a, b)_l <- (a_l a_{l-d}, a_l b_{l-d} + b_l),
// the identity map (1, 0) standing in below lane d.
__device__ __forceinline__ void warp_scan(double& a, double& b, int lane,
                                          int width) {
  for (int d = 1; d < width; d <<= 1) {
    double pa = __shfl_up_sync(kFull, a, d);
    double pb = __shfl_up_sync(kFull, b, d);
    pa = lane >= d ? pa : 1.0;
    pb = lane >= d ? pb : 0.0;
    b = a * pb + b;
    a = a * pa;
  }
}

template <int K, int T, int MINB>
__global__ void __launch_bounds__(T, MINB)
march_ds_kernel(Rows rows, double* __restrict__ out, int n_steps, int NE,
                double w0, double w1, double w2) {
  __shared__ double tot_a[2][kMaxWarps], tot_b[2][kMaxWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nW = blockDim.x >> 5;
  const int j0 = tid * K;
  const double W[3] = {w0, w1, w2};
  const double W2[3] = {w0 * w0, w1 * w1, w2 * w2};
  const size_t base = (size_t)blockIdx.x * n_steps * NE;

  double f[K][3];
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int c = 0; c < 3; ++c) f[k][c] = 0.0;

  Bin cur[K];
  load_bins<K>(rows, base, 0, j0, NE, cur);

  for (int t = 0; t < n_steps; ++t) {
    // the next node's rows, in flight during this node's work (the last
    // node asks for its own rows again and drops them)
    const size_t dn = (size_t)(t + 1 < n_steps ? t + 1 : t) * NE;
    Bin nxt[K];
    load_bins<K>(rows, base + dn, dn, j0, NE, nxt);

    double V[K][3], U[K][3], a[K], b[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
      node(cur[k], f[k], W, W2, V[k], U[k], a[k], b[k]);

    // the thread's K maps composed in bin order, then the warp's scan
    double sa = a[0], sb = b[0];
#pragma unroll
    for (int k = 1; k < K; ++k) {
      sb = a[k] * sb + b[k];
      sa = a[k] * sa;
    }
    warp_scan(sa, sb, lane, 32);
    const int p = t & 1;
    if (lane == 31) {
      tot_a[p][warp] = sa;
      tot_b[p][warp] = sb;
    }
    // the map of the lanes before this one in its warp
    double ea = __shfl_up_sync(kFull, sa, 1);
    double eb = __shfl_up_sync(kFull, sb, 1);
    ea = lane > 0 ? ea : 1.0;
    eb = lane > 0 ? eb : 0.0;

    __syncthreads();  // the one barrier of a node

    double ta = lane < nW ? tot_a[p][lane] : 1.0;
    double tb = lane < nW ? tot_b[p][lane] : 0.0;
    warp_scan(ta, tb, lane, nW);
    // the state entering this warp: the warps before it, applied to 0
    double cw = __shfl_sync(kFull, tb, warp > 0 ? warp - 1 : 0);
    cw = warp > 0 ? cw : 0.0;

    double cum = ea * cw + eb;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const double cd = cum * cur[k].dw;
      for (int c = 0; c < 3; ++c) f[k][c] = V[k][c] + cd * U[k][c];
      cum = a[k] * cum + b[k];
      cur[k] = nxt[k];
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = j0 + k;
    if (j < NE)
      for (int c = 0; c < 3; ++c)
        out[((size_t)blockIdx.x * 3 + c) * NE + j] = f[k][c];
  }
}

template <int K_, int T_, int MINB_>
struct Shape {
  static constexpr int K = K_, T = T_, MINB = MINB_;
};

// Calls fn with the Shape (bins per thread, thread bound, resident blocks
// asked) that serves NE bins.
template <typename Fn>
int with_shape(int NE, Fn&& fn) {
  if (NE <= kThreads) return fn(Shape<1, kThreads, kMinBlocks>{});
  if (NE <= 2 * kThreads) return fn(Shape<2, kThreads, kMinBlocks>{});
  if (NE <= 4 * kThreads) return fn(Shape<4, kThreads, 1>{});
  if (NE <= 8 * kThreads) return fn(Shape<8, kThreads, 1>{});
  return fn(Shape<16, kWideThreads, 1>{});
}

// Threads launched for NE bins at K bins per thread: whole warps.
int threads_for(int NE, int K) { return ((NE + K - 1) / K + 31) / 32 * 32; }

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
  return with_shape(NE, [&](auto shape) {
    using S = decltype(shape);
    march_ds_kernel<S::K, S::T, S::MINB>
        <<<B, threads_for(NE, S::K), 0, s>>>(rows, out, n_steps, NE, w0, w1,
                                             w2);
    return (int)cudaGetLastError();
  });
}

// The launch at NE bins and what the card makes of it. out: threads per
// block, bins per thread, block barriers per node, shared memory per
// block (bytes), registers per thread, local memory per thread (bytes:
// spills), resident blocks per SM from the occupancy calculator, and the
// most bins a launch takes. Returns a cudaError_t.
int march_ds_config(int NE, int* out) {
  return with_shape(NE, [&](auto shape) {
    using S = decltype(shape);
    auto kernel = march_ds_kernel<S::K, S::T, S::MINB>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    const int threads = threads_for(NE, S::K);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, 0);
    out[0] = threads;
    out[1] = S::K;
    out[2] = 1;
    out[3] = (int)attr.sharedSizeBytes;
    out[4] = attr.numRegs;
    out[5] = (int)attr.localSizeBytes;
    out[6] = blocks;
    out[7] = 16 * kWideThreads;
    return (int)err;
  });
}

const char* march_ds_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
