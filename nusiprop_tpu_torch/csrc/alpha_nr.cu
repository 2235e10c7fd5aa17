// The non-resonant alpha table's per-pair quadrature, for NVIDIA Hopper
// (sm_90a), float32 with float64 coordinates: the per-pair part of
// models/kernels_nr_f32.py::alpha_table_f32 (its twin _pairs_plain) in one
// launch.
//
// It replaces no pallas_call: the JAX package leaves this table to XLA
// (nusiprop_tpu/models/kernels_nr_f32.py::alpha_table_f32 is elementwise
// code over the gathered pairs). The port's plain twin runs it as ~3,500
// tensor operations over (points, 3 states, N(N-1)/2 pairs) arrays, each
// streaming a 255 MB intermediate through device memory at the benchmark's
// batch of 128 points and 577 bins, and holding ~18 GB of them at once.
//
// This kernel gives each (point, pair) one thread. The thread reads the
// per-bin arrays that ops/alpha_nr.py packs from _per_bin (the row's and
// the column's float64 coordinates, float32 factors and flags), and for
// each of the three mass states, in registers and in the twin's order:
//
// * the per-pair float64 set-up of the three trapezoid segments (their
//   bounds, the geometric panel ratio, q_lo, the offsets), cast to float32
//   where the twin casts;
// * the t/u, tu and far-resonance su quadrature: 3 segments x 3 geometric
//   panels x 3 q-nodes x 3 x-nodes;
// * the st interference, T_st(row) x X_st(column), and near the resonance
//   the su interference from the exact moments J0..J2 and the quadratic
//   fit of the cofactor at three GL5 nodes, for each GL3 y-node;
// * the floor mask, the s channel's pair product, and the sum over states
//   of w_e * tot as PyTorch's reduction adds them, ((0+v0) + (0+v1)) +
//   (0+v2) + 0, written straight into the table.
//
// Where the twin selects with torch.where (near or far su, the floor mask,
// a column block's invalid pairs), only the selected branch is computed:
// the value is the same. Every multiply, add and divide is its own IEEE
// round-to-nearest operation (--fmad=false; no fast-math), log1pf and
// expm1f are the CUDA math library's (as PyTorch's log1p and expm1), a
// division by a Python scalar is the multiply by its float32 reciprocal
// (PyTorch's CUDA true division by a CPU scalar), and each constant below
// is the float32 that PyTorch rounds the twin's Python double to
// (tests/test_torch_alpha_nr.py holds them to the twin's module). So
// the table is the twin's bit for bit.
//
// What bounds it: operations. Counted from this source, each add,
// multiply, division, min/max/clamp and math-library call (log1pf, expm1f)
// one, an entry (point, state, pair) takes 2,772 float32 operations far
// from the resonance (81 x-nodes of 25, 27 q-nodes of 27, 3 segments of 2,
// 12 at the pair's end), 2,220 near it (x-nodes of 17 without the far su
// term, q-nodes of 25, and 150 for the su fit), 1,742 in a Dirac table
// (x-nodes of 13, 8 at the pair's end) and 5 off the floor mask (the s
// channel and the sum). Its output is 4 bytes a pair, so the card's
// float32 rate, not its memory, sets the least time: chip_smoke.py's bound
// (ALPHA_OPS) runs these operations at half the float32 peak that counts
// a fused multiply-add as two, since with --fmad=false each is its own
// instruction, and counts a division, log1pf or expm1f as one of them.
// The design keeps every intermediate in registers (none of the twin's
// device-memory round trips), gives a block one point and one row, so the
// row's data are one broadcast and the columns' are coalesced reads that
// stay in L1/L2, and computes no branch the twin discards.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// ---- the twin's constants as PyTorch rounds them to float32 ----
// _GL3_C, _GL3_W (zip(_GL3_C, _GL3_W) order)
__constant__ float kGL3C[3] = {1.127016619e-01f, 5.000000000e-01f,
                               8.872983456e-01f};
__constant__ float kGL3W[3] = {2.777777910e-01f, 4.444444478e-01f,
                               2.777777910e-01f};
// _GL5_C[0], _GL5_C[2], _GL5_C[4]: the near-resonance fit's nodes
__constant__ float kGL5C024[3] = {4.691007733e-02f, 5.000000000e-01f,
                                  9.530899525e-01f};
// _r32(float32(k) + float32(cq)), k = 0.._NPANEL-1 (rows), cq in _GL3_C
__constant__ float kQNode[9] = {
    1.127016619e-01f, 5.000000000e-01f, 8.872983456e-01f,
    1.112701654e+00f, 1.500000000e+00f, 1.887298346e+00f,
    2.112701654e+00f, 2.500000000e+00f, 2.887298346e+00f};
// 1.0 / _NPANEL
__constant__ float kInvPanel = 3.333333433e-01f;
// 1 / (16 pi), 1 / (32 pi)
__constant__ float kInv16Pi = 1.989436708e-02f;
__constant__ float kInv32Pi = 9.947183542e-03f;
// dirac_half / (8 pi): Majorana, Dirac
__constant__ float kSChannel[2] = {3.978873417e-02f, 1.989436708e-02f};
// _quad_fit's divisions by Python scalars, as multiplies by the float32
// reciprocals: 1 / (2 _r32(_XI)), 1 / (2 _r32(_XI * _XI))
__constant__ float kFit1 = 5.517668724e-01f;
__constant__ float kFit2 = 6.088933349e-01f;

// torch.minimum / torch.maximum (NaN-propagating) and torch.clamp(min=0)
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ double tmin(double a, double b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}
__device__ __forceinline__ double tmax(double a, double b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// The per-bin arrays of one (point, state), laid out by ops/alpha_nr.pack.
struct Bins {
  const double* b64;   // [n][4]: tpb_f, dt_r, smb_f, ds_c
  const float* b32;    // [n][8]: T_st, S_row, vm, J0, J1, J2, X_st, Q
  const uint8_t* flg;  // [n]: 1 row_ok, 2 col_ok, 4 near
};

// The su interference near the resonance: sum over GL3 y-nodes of the
// quadratic cofactor fit against the column's exact moments (not yet
// multiplied by dt).
__device__ __forceinline__ float near_su(float xy0, float ds, float dt,
                                         float smp, float J0, float J1,
                                         float J2) {
  float acc = 0.0f;
#pragma unroll
  for (int jj = 0; jj < 3; ++jj) {
    float h[3];
#pragma unroll
    for (int ii = 0; ii < 3; ++ii) {
      const float ci = kGL5C024[ii];
      const float u = -((xy0 + ds * ci) + dt * kGL3C[jj]);
      const float inv_x = 1.0f / (smp + ds * ci);
      h[ii] = ((u * 2.0f) / (u - 1.0f)) * inv_x;
    }
    const float c0 = h[1];
    const float c1 = (h[2] - h[0]) * kFit1;
    const float c2 = ((h[0] + h[2]) - h[1] * 2.0f) * kFit2;
    acc = acc + (((c0 * J0) + (c1 * J1)) + (c2 * J2)) * kGL3W[jj];
  }
  return acc;
}

// ch_tu + ch_st of one pair and state whose floor mask holds.
template <bool kMajorana>
__device__ __forceinline__ float pair_nr(const Bins& s, int r, int c,
                                         float gr2) {
  const double tpf = s.b64[4 * r + 0];
  const double dt64 = s.b64[4 * r + 1];
  const double smpf = s.b64[4 * c + 2];
  const double ds64 = s.b64[4 * c + 3];
  const double xy0_64 = smpf + tpf;
  const float tp = (float)tpf, dt = (float)dt64;
  const float smp = (float)smpf, ds = (float)ds64;
  const float xy0 = (float)xy0_64;
  const float vm = s.b32[8 * c + 2];
  const bool near = (s.flg[c] & 4) != 0;

  const double m1_64 = tmin(ds64, dt64);
  const double m2_64 = tmax(ds64, dt64);
  const double mt_64 = ds64 + dt64;
  const float m1c = (float)m1_64;

  float acc_tu = 0.0f, acc_su = 0.0f;
#pragma unroll 1
  for (int seg = 0; seg < 3; ++seg) {
    // the segments [0, m1], [m1, m2], [m2, mt]
    const double dlo64 = seg == 0 ? 0.0 : (seg == 1 ? m1_64 : m2_64);
    const double dhi64 = seg == 0 ? m1_64 : (seg == 1 ? m2_64 : mt_64);
    const double q64 = (xy0_64 + 1.0) + dlo64;
    const float dlo = (float)dlo64;
    const float ratm1 = (float)((dhi64 - dlo64) / q64);
    const float qlo = (float)q64;
    const float d_a = (float)(dlo64 - dt64);
    const float mtref = (float)(mt_64 - dlo64);
    const float mu0 = (float)(xy0_64 + dlo64);
    const float lnrho = log1pf(ratm1) * kInvPanel;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float dD = qlo * expm1f(lnrho * kQNode[3 * k + q]);
        const float Delta = dlo + dD;
        const float a = tmax(0.0f, dD + d_a);
        const float mtmd = mtref - dD;
        const float wx = clamp0(tmin(tmin(Delta, mtmd), m1c));
        const float dY = tmin(dt, Delta);
        const float mu = mu0 + dD;
        const float inv_qv = 1.0f / (mu + 1.0f);
        const float c_i = (mu * 2.0f) * inv_qv;
        const float c_u = (mu * inv_qv) * (mu * inv_qv);
        const float wgt_q = ((lnrho * kGL3W[q]) * (qlo + dD)) * wx;
        float row_tu = 0.0f, row_su = 0.0f;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float cw = wx * kGL3C[x];
          const float ofs = a + cw;
          const float xx = smp + ofs;
          const float y = tp + (dY - cw);
          const float inv_x = 1.0f / xx;
          const float inv_x2 = inv_x * inv_x;
          const float rr = y / (y - 1.0f);
          float val;
          if (kMajorana) {
            val = inv_x2 * ((((rr * rr) + c_u) * 2.0f) + (c_i * rr));
            if (!near) {
              const float v_x = vm + ofs;
              row_su = row_su + (((c_i * v_x) * inv_x) / ((v_x * v_x) + gr2))
                                    * kGL3W[x];
            }
          } else {
            val = inv_x2 * (rr * rr);
          }
          row_tu = row_tu + val * kGL3W[x];
        }
        acc_tu = acc_tu + wgt_q * row_tu;
        if (kMajorana && !near) acc_su = acc_su + wgt_q * row_su;
      }
    }
  }
  const float ch_tu = acc_tu * kInv16Pi;

  float ch_st = s.b32[8 * r + 0] * s.b32[8 * c + 6];
  if (kMajorana) {
    const float su =
        near ? near_su(xy0, ds, dt, smp, s.b32[8 * c + 3], s.b32[8 * c + 4],
                       s.b32[8 * c + 5]) * dt
             : acc_su;
    ch_st = (ch_st + su) * 2.0f;
  }
  ch_st = ch_st * kInv32Pi;
  return ch_tu + ch_st;
}

// One thread a (point b, row r, column c0 + j). Full table (full): the
// columns j > r of out[b][r][0..N), the rest left as the caller's zeros.
// Column block: every j of out[b][r][0..C), 0 where the pair is not in the
// strict upper triangle. per_state: out[b][e][r][j] = w_e * tot_e, else
// out[b][r][j] = sum over e of w_e * tot_e in PyTorch's reduction order.
template <bool kMajorana>
__global__ void __launch_bounds__(kThreads)
    alpha_nr_kernel(const double* __restrict__ bin64,
                    const float* __restrict__ bin32,
                    const uint8_t* __restrict__ flags,
                    const float* __restrict__ gr2,
                    const float* __restrict__ w, float* __restrict__ out,
                    int N, int c0, int C, int col_tiles, bool full,
                    bool per_state) {
  const long long b = blockIdx.x / col_tiles;
  const int tile = blockIdx.x - (int)(b * col_tiles);
  const int r = blockIdx.y;
  const int j = tile * kThreads + threadIdx.x;
  if (j >= C || (full && j <= r)) return;
  const int craw = c0 + j;
  const bool valid = r < craw && craw < N;
  const int c = craw < N ? craw : N - 1;
  const float g2 = gr2[b];
  const float s_fac = kSChannel[kMajorana ? 0 : 1];

  float sum = 0.0f;
#pragma unroll 1
  for (int e = 0; e < 3; ++e) {
    const long long bin0 = (b * 3 + e) * (long long)N;
    const Bins s{bin64 + 4 * bin0, bin32 + 8 * bin0, flags + bin0};
    float tot = 0.0f;
    if (valid) {
      const bool ok = (s.flg[r] & 1) && (s.flg[c] & 2);
      const float nr = ok ? pair_nr<kMajorana>(s, r, c, g2) : 0.0f;
      const float ch_s = (s.b32[8 * r + 1] * s.b32[8 * c + 7]) * s_fac;
      tot = nr + ch_s;
    }
    const float v = w[3 * b + e] * tot;
    if (per_state) {
      out[((b * 3 + e) * N + r) * (long long)C + j] = v;
    } else {
      sum = sum + (0.0f + v);
    }
  }
  if (!per_state) out[(b * N + r) * (long long)C + j] = sum + 0.0f;
}

}  // namespace

extern "C" {

// Launch the table of B points over N bins into out (float32, zeroed by the
// caller for the full table): full != 0 for the strict upper triangle of
// (B, N, N), else the column block [c0, c0 + C) of (B, N, C); per_state
// != 0 for (B, 3, N, C) per-state entries. Returns the cudaError_t of the
// launch.
int alpha_nr_launch(const double* bin64, const float* bin32,
                    const unsigned char* flags, const float* gr2,
                    const float* w, float* out, long long B, int N, int c0,
                    int C, int full, int majorana, int per_state,
                    void* stream) {
  const int col_tiles = (C + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(B * col_tiles), (unsigned)N);
  if (majorana) {
    alpha_nr_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        bin64, bin32, flags, gr2, w, out, N, c0, C, col_tiles, full != 0,
        per_state != 0);
  } else {
    alpha_nr_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        bin64, bin32, flags, gr2, w, out, N, c0, C, col_tiles, full != 0,
        per_state != 0);
  }
  return (int)cudaGetLastError();
}

const char* alpha_nr_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
