// The non-resonant fused trisolve march for NVIDIA Hopper (sm_90a), as a
// tiled back-substitution with one block barrier per tile.
//
// Replaces the Pallas TPU kernel nusiprop_tpu/ops/march_tri.py::_make_kernel
// (launched by _pallas_march). It computes what that kernel computes — the
// whole redshift march of one parameter point — for each z-node t, with
// window offset off = Nz-2-t:
//   1. the Sherman-Morrison reduction (sm_node, the JAX _sm_node) gives
//      c1 = CS*qv and c2 = CS*pu for every bin;
//   2. the descending back-substitution over the window, the strictly
//      upper-triangular NE x NE block of A at (off, off):
//          p_j = sum_{k>j} A[off+j, off+k] * cy_k,   cy_j = c1_j + c2_j * p_j;
//   3. x_k = V_k + PT * p * U_k, the carry phi of the next node.
//
// What bounds it on this card: the chain at small batch, the window reads
// at the production batch. Step 2 is NE dependent steps per node, Nz-1
// nodes deep: one warp-shuffle step each here, so ~39,000 of them at
// NE 500 / Nz 79 whatever the batch. The window reads are NE(NE-1)/2 * 4 B
// = 0.5 MB per node and point at NE 500, 5.0 GB in all at batch 128
// (~1.5 ms at 3.35 TB/s, less what L2 keeps from one node to the next: the
// 64 MB of windows in flight exceed its 50 MB). The bound counts each band
// entry once (224 MB, 67 us), which only a design that keeps a point's
// 0.65 MB band on chip could reach: one block's 227 KB cannot. The design
// before this one took a block barrier and a global-load round trip for
// every bin (39,000 dependent block-wide steps, ~41 ms).
//
// What this design does about it:
// * One 512-thread block per point; the loop over z-nodes runs inside the
//   block (the TPU's sequential grid axis). The bins are cut into tiles
//   of T = 32 (one warp), taken from the highest bin down; the lowest tile
//   is ragged (NE 500 = 15 x 32 + 20). Each tile costs one __syncthreads,
//   so a node takes ceil(NE/T) + 1 barriers instead of NE.
// * Warp 0 solves the tile's 32x32 diagonal triangle in registers: lane i
//   holds row i of the block (32 floats, fully unrolled), and for k from
//   the top column down, lane k forms cy_k = c1 + c2*p_k, __shfl_sync
//   broadcasts it, and lanes i < k add A[i][k]*cy_k: 32 branch-free steps.
//   The same sweep folds cy_k into the NEXT tile's rows (a second 32-float
//   register row), so the block just below the diagonal needs no barrier
//   either.
// * Look-ahead: while warp 0 sweeps tile J, warps 1..15 compute tile
//   J+1's left-looking panel over the columns of tiles < J, all of them
//   already solved: each warp takes 32-column chunks, each lane loads its
//   column of all 32 rows (32 independent coalesced loads in flight per
//   lane), and a butterfly transpose-reduce leaves row i's sum in lane i.
//   The same warps stage tile J+1's diagonal block and the block below it
//   into a double-buffered shared slice, their loads issued before the
//   panel's. Every address is known from the tile index alone, so no load
//   waits on a value of the chain.
// * The panel is a matrix-vector product with a different table for each
//   point: it has no reuse for the tensor cores.
// * No bin ceiling: shared memory is 7*NE floats plus fixed staging
//   (2 x two 32x33 blocks, 2 x 15 x 32 partial sums): 49 KB at NE 1024,
//   one block per SM. The launcher raises the dynamic shared-memory limit.
//
// Arithmetic: built with --fmad=false, so every elementwise step rounds as
// the plain PyTorch twin (ops/march_tri.py::march_tri_plain) does; the
// only difference from the twin is the f32 summation order of the row dot
// (the tile above, the panel's partials, then the tile itself).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkers = kWarps - 1;       // warps 1..15: panel and staging
constexpr int kT = 32;                     // tile width: one warp
constexpr int kLd = kT + 1;                // padded staged row: no bank conflicts
constexpr int kBlock = kT * kLd;           // one staged 32x32 block
constexpr int kStage = 2 * kBlock;         // diagonal block, then the one below
constexpr unsigned kFull = 0xffffffffu;

struct Rows {
  const float *pg, *pat, *co, *r0, *s0, *cs, *pt;
};

// The Sherman-Morrison algebra of one bin (_sm_node), in its association
// order. Both passes of a node recompute it from the rows and the carry,
// so shared memory holds no U and V.
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

// Tile J holds the bins [tile_lo(J), tile_hi(J)); tile 0 the highest. Past
// the last tile both are 0.
__device__ __forceinline__ int tile_hi(int NE, int J) {
  return max(0, NE - kT * J);
}
__device__ __forceinline__ int tile_lo(int NE, int J) {
  return max(0, NE - kT * (J + 1));
}

// Staging of tile J's diagonal block (rows and columns of tile J, upper
// part only) and the block below it (rows of tile J+1, columns of tile J),
// zero elsewhere: 2*T staged rows, row s taken by worker warp s % kWorkers,
// one coalesced load per lane (column `lane`). The loads go to registers
// first, so that they are in flight together with the panel's. Aw is the
// window origin: Aw[j*NEXT + k] = A[off+j, off+k].
constexpr int kStagePer = (2 * kT + kWorkers - 1) / kWorkers;

__device__ __forceinline__ void stage_load(const float* __restrict__ Aw,
                                           int NEXT, int NE, int J, int w,
                                           int lane, float (&v)[kStagePer]) {
  const int lo = tile_lo(NE, J), n = tile_hi(NE, J) - lo;
  const int lo1 = tile_lo(NE, J + 1), n1 = lo - lo1;
#pragma unroll
  for (int u = 0; u < kStagePer; ++u) {
    const int s = w + u * kWorkers;
    const int r = s < kT ? s : s - kT;
    const bool live = lane < n && (s < kT ? r < n && lane > r : r < n1);
    const int row = s < kT ? lo + r : lo1 + r;
    v[u] = live ? Aw[(size_t)row * NEXT + lo + lane] : 0.0f;
  }
}

__device__ __forceinline__ void stage_store(float* dst, int w, int lane,
                                            const float (&v)[kStagePer]) {
#pragma unroll
  for (int u = 0; u < kStagePer; ++u) {
    const int s = w + u * kWorkers;
    if (s < 2 * kT) dst[s * kLd + lane] = v[u];
  }
}

// One level of the butterfly transpose-reduce (S a constant, so that every
// index into `a` is one and `a` stays in registers).
template <int S>
__device__ __forceinline__ void butterfly(float (&a)[kT], int lane) {
  const bool upper = lane & S;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float send = upper ? a[k] : a[k + S];
    const float keep = upper ? a[k + S] : a[k];
    a[k] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// Worker warp w's share of tile J+1's panel over the columns of tiles < J,
// [NE - T*J, NE): the 32-column chunks q = w, w + kWorkers, ... < J. Each
// chunk is one column per lane: its 32 rows are loaded at once, scaled by
// cy, and a butterfly transpose-reduce leaves row i's sum over the chunk
// in lane i (after the step of width s, lane L keeps the rows whose bit s
// equals L's). One chunk's 32 floats are all that is live, so ptxas can
// keep every load in flight. A ragged tile J+1 (the lowest) still loads
// 32 rows: the rows past it are those of tile J, inside the window, and
// feed only lanes that hold no bin. Lane i ends with row i's partial sum
// in part[w*T + i]; a warp with no chunk writes nothing (the solver knows
// which warps had one).
__device__ __forceinline__ void panel(const float* __restrict__ Aw,
                                      int NEXT, int NE, int J,
                                      const float* cy, float* part, int w,
                                      int lane) {
  if (w >= J) return;
  const float* rows = Aw + (size_t)tile_lo(NE, J + 1) * NEXT;
  float sum = 0.0f;
  for (int q = w; q < J; q += kWorkers) {
    const int c = NE - kT * (J - q) + lane;
    float a[kT];
#pragma unroll
    for (int r = 0; r < kT; ++r) a[r] = rows[(size_t)r * NEXT + c];
    const float y = cy[c];
#pragma unroll
    for (int r = 0; r < kT; ++r) a[r] = a[r] * y;
    butterfly<16>(a, lane);
    butterfly<8>(a, lane);
    butterfly<4>(a, lane);
    butterfly<2>(a, lane);
    butterfly<1>(a, lane);
    sum = sum + a[0];
  }
  part[w * kT + lane] = sum;
}

__global__ void __launch_bounds__(kThreads, 1)
march_tri_kernel(const float* __restrict__ A, Rows rows,
                 float* __restrict__ out, int NE, int Nz, int NEXT,
                 float w0, float w1, float w2) {
  extern __shared__ float smem[];
  float* stage = smem;                     // [2][kStage]
  float* part = stage + 2 * kStage;        // [2][kWorkers][kT]
  float* cy = part + 2 * kWorkers * kT;    // NE, window coordinates
  float* pv = cy + NE;                     // NE: the final p of each bin
  float* c1 = pv + NE;                     // NE
  float* c2 = c1 + NE;                     // NE
  float* phi = c2 + NE;                    // 3 * NE

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x;
  const int Ns = Nz - 1;
  const int nT = (NE + kT - 1) / kT;
  const float* Ab = A + (size_t)b * NEXT * NEXT;
  const size_t row_base = (size_t)b * Ns * NE;
  const float W[3] = {w0, w1, w2};
  const float W2[3] = {w0 * w0, w1 * w1, w2 * w2};

  // phi[.][j] belongs to thread j % kThreads, which alone reads and
  // writes it: no barrier guards it
  for (int j = tid; j < NE; j += kThreads)
    phi[j] = phi[NE + j] = phi[2 * NE + j] = 0.0f;
  // warp 0: the next tile's rows summed over the current tile's columns
  float pn = 0.0f;

  for (int t = 0; t < Ns; ++t) {
    const int off = Nz - 2 - t;
    const float* Aw = Ab + (size_t)off * NEXT + off;
    const size_t rb = row_base + (size_t)t * NE;

    // ---- Sherman-Morrison per bin (owner thread j % kThreads) ----
    for (int j = tid; j < NE; j += kThreads) {
      const SmNode n = sm_node(rows, rb + j, phi + j, NE, W, W2);
      const float CS = rows.cs[rb + j];
      c1[j] = CS * (n.wv * n.inv_s);
      c2[j] = CS * (rows.pt[rb + j] * (n.wu * n.inv_s));
    }
    if (warp > 0) {
      float v[kStagePer];
      stage_load(Aw, NEXT, NE, 0, warp - 1, lane, v);
      stage_store(stage, warp - 1, lane, v);
    }
    __syncthreads();

    // ---- the tiles, highest bins first: one barrier each ----
    for (int J = 0; J < nT; ++J) {
      if (warp == 0) {
        const int lo = tile_lo(NE, J), n = tile_hi(NE, J) - lo;
        const float* D = stage + (J & 1) * kStage;
        float Ad[kT], As[kT];
#pragma unroll
        for (int m = 0; m < kT; ++m) {
          Ad[m] = D[lane * kLd + m];
          As[m] = D[kBlock + lane * kLd + m];
        }
        // the panel of tiles < J-1 (computed during step J-1) and the
        // columns of tile J-1 (folded in by this warp's last sweep)
        float p = J > 0 ? pn : 0.0f;
        const float* pp = part + (J & 1) * kWorkers * kT;
        const int nw = min(J - 1, kWorkers);
        for (int w = 0; w < nw; ++w) p = p + pp[w * kT + lane];
        const bool live = lane < n;
        const float a1 = live ? c1[lo + lane] : 0.0f;
        const float a2 = live ? c2[lo + lane] : 0.0f;
        float my_cy = 0.0f, my_p = 0.0f;
        pn = 0.0f;
        // all 32 columns, branch-free: in a ragged tile a lane k >= n has
        // c1 = c2 = 0 and a finite p, so y = 0, and its staged columns are
        // 0, so it adds +0 to the live lanes
#pragma unroll
        for (int k = kT - 1; k >= 0; --k) {
          const float y = __shfl_sync(kFull, a1 + a2 * p, k);
          if (lane == k) {
            my_cy = y;
            my_p = p;
          }
          if (lane < k) p = p + Ad[k] * y;
          pn = pn + As[k] * y;
        }
        if (live) {
          cy[lo + lane] = my_cy;
          pv[lo + lane] = my_p;
        }
      } else if (J + 1 < nT) {
        float v[kStagePer];
        stage_load(Aw, NEXT, NE, J + 1, warp - 1, lane, v);
        panel(Aw, NEXT, NE, J, cy, part + ((J + 1) & 1) * kWorkers * kT,
              warp - 1, lane);
        stage_store(stage + ((J + 1) & 1) * kStage, warp - 1, lane, v);
      }
      __syncthreads();
    }

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

size_t smem_bytes(int NE) {
  return (size_t)(2 * kStage + 2 * kWorkers * kT + 7 * NE) * sizeof(float);
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
  const size_t smem = smem_bytes(NE);
  cudaError_t err = cudaFuncSetAttribute(
      march_tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Rows rows{pg, pat, co, r0, s0, cs, pt};
  march_tri_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      A, rows, out, NE, Nz, NEXT, w0, w1, w2);
  return (int)cudaGetLastError();
}

// The launch's design at NE bins: out[0] threads per block, out[1] tile
// width in bins, out[2] dynamic shared memory in bytes.
void march_tri_config(int NE, int* out) {
  out[0] = kThreads;
  out[1] = kT;
  out[2] = (int)smem_bytes(NE);
}

const char* march_tri_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
