// Whole dual-decoder greedy decode (direct mode) in one launch, for Hopper.
//
// Replaces the TPU kernel mvc_tpu/ops/pallas_dual_greedy.py:
// dual_greedy_decode_pallas (_dual_kernel / _dual_kernel_resident).  For
// L-1 steps each of the two decoders embeds its OWN previous argmax, runs
// masked additive attention over T frames (over P = feats @ wi_ctx when the
// decoder is factored), applies the LSTM/GRU gates (gates.cuh) and projects
// onto the shared vocabulary.  Three running argmaxes per row (visual,
// audio, fused l_v + l_a) break ties to the lowest index; the fused one is
// the reported token.  Output: int32 [B, max_len], column 0 = 0.
//
// What bounds it on this card: operations.  At the serving shape (B=64,
// T=16, L=30, V=4000, H=512, E=300) one call does ~29.7 GFLOP of float32
// matrix-vector work on ~41 MB of float32 weights: 0.44 ms at the 67 TFLOP/s
// float32 (non-tensor-core) peak, against ~0.02 ms to read its bytes once.
// The weights fit in the 50 MB L2, but every step needs every weight again,
// so in practice the rate at which SMs can pull weights out of L2 decides.
//
// What the design does about it: rows are independent, so a cluster of CL
// blocks owns ROWS batch rows and runs all steps of both decoders with no
// grid-wide sync.  Each block of the cluster owns 1/CL of every weight's
// output columns (attention query, gate units, vocab slice) and streams
// only those, so a step's weights are read once per cluster, spread over
// CL SMs, and each load feeds ROWS rows held in registers.  The new hidden
// state, the query and the argmax candidates are exchanged through
// distributed shared memory with one cluster barrier each; the attention
// weights and the step input are recomputed by every block of the cluster
// (a few thousand operations per row).  Each lane loads four neighbouring
// columns of the row-major [in, out] weights at once and neighbouring lanes
// neighbouring groups, so loads are wide and coalesced; K is split across
// lanes and, for short slices, across warps.  The step's logits stay in
// shared memory (the block's vocab slice) and only argmax candidates
// leave the block.  wgmma, TMA and asynchronous copies are the next steps
// (a later change).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gates.cuh"

namespace cg = cooperative_groups;

struct DecoderArgs {
  const void* slab;      // [B, T, S] WT: P = feats @ wi[E:] (factored, S=G*H) or feats (S=F)
  const void* keys;      // [B, T, A] WT: feats @ U
  const void* emb;       // [V, E] WT
  const void* attn_W;    // [H, A] WT
  const void* wi;        // [E + F, G*H] WT, embedding rows first
  const void* wh;        // [H, G*H] WT
  const void* wout;      // [H, V] WT
  const float* attn_b;   // [A]
  const float* w_row;    // [A]
  const float* b_gates;  // [G*H]: bi + bh (LSTM) or bi (GRU)
  const float* b_h;      // [G*H]: bh (GRU); unread for an LSTM
  const float* b_out;    // [V]
  int F, H, A, E, cell, factored;
};

struct DualGreedyArgs {
  DecoderArgs dec[2];    // [visual, audio]
  const float* mask;     // [B, T]: > 0 = attendable frame
  int* tokens;           // [B, max_len] out
  int B, T, max_len, V, sos_id;
};

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int CL = 8;            // blocks per cluster
constexpr int ROWS = 8;          // batch rows per cluster
constexpr float NEG = -1e30f;    // masked energy, as the TPU kernel

template <typename WT>
__device__ __forceinline__ float ld(const WT* p, size_t i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, size_t i) { return p[i]; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// The value a float takes once stored in the weight type (the TPU kernel's
// astype(weight_dtype) rounding points).
template <typename WT>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int n_gates(const DecoderArgs& d) {
  return d.cell == MVC_CELL_LSTM ? 4 : 3;
}

__host__ __device__ inline int step_input_width(const DecoderArgs& d) {
  return d.factored ? d.E : d.E + d.F;
}

// Columns of a gate slice: G gates x this block's ceil(H / CL) units.
__host__ __device__ inline int gate_cols(const DecoderArgs& d) {
  return n_gates(d) * cdiv(d.H, CL);
}

// Shared-memory layout, in floats, identical in every block of a cluster
// (distributed shared memory addresses a peer's copy by the same offset).
struct Layout {
  int h[2], c[2], x[2], q[2], att[2];   // per decoder
  int part, ax, ah, logits, gather_v, gather_i, red_v, red_i, prev, total;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Every region starts on a 16-byte boundary (float4 reads of the inputs).
__host__ __device__ inline Layout layout(const DualGreedyArgs& a) {
  Layout L;
  int o = 0;
  int gc = 0;
  for (int d = 0; d < 2; ++d) {
    const DecoderArgs& D = a.dec[d];
    L.h[d] = o;   o = round4(o + 2 * ROWS * D.H);                  // [2][ROWS][H] state, double-buffered
    L.c[d] = o;   o = round4(o + ROWS * cdiv(D.H, CL));            // [ROWS][own units]
    L.x[d] = o;   o = round4(o + ROWS * step_input_width(D));      // [ROWS][Kx] = [emb ; ctx]
    L.q[d] = o;   o = round4(o + ROWS * D.A);                      // [ROWS][A]
    L.att[d] = o; o = round4(o + ROWS * a.T);                      // [ROWS][T]
    gc = gate_cols(D) > gc ? gate_cols(D) : gc;
  }
  int pc = gc > NT ? gc : NT;
  pc = cdiv(a.V, CL) > pc ? cdiv(a.V, CL) : pc;
  L.part = o;     o = round4(o + ROWS * pc);                       // split-K partial sums
  L.ax = o;       o = round4(o + ROWS * gc);                       // x-side gate sums
  L.ah = o;       o = round4(o + ROWS * gc);                       // h-side gate sums
  L.logits = o;   o = round4(o + 2 * ROWS * cdiv(a.V, CL));         // [2][ROWS][vocab slice]
  L.gather_v = o; o = round4(o + CL * 3 * ROWS);                   // argmax candidates of every block
  L.gather_i = o; o = round4(o + CL * 3 * ROWS);
  L.red_v = o;    o = round4(o + NWARPS * 3 * ROWS);               // in-block argmax reduction
  L.red_i = o;    o = round4(o + NWARPS * 3 * ROWS);
  L.prev = o;     o = round4(o + 2 * ROWS);                        // previous token per decoder, row
  L.total = o;
  return L;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Four weights of row `off` (element offset of the row start): the columns
// cols[0..3], or one 16-byte (8-byte for bf16) load when they are
// consecutive and aligned.  A column < 0 reads as 0.
template <typename WT>
__device__ __forceinline__ void load4(const WT* __restrict__ W, size_t off, const int (&cols)[4],
                                      bool vec, float (&w)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* __restrict__ W, size_t off,
                                             const int (&cols)[4], bool vec, float (&w)[4]) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(W + off + cols[0]);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = cols[c] >= 0 ? W[off + cols[c]] : 0.f;
  }
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* __restrict__ W,
                                                     size_t off, const int (&cols)[4], bool vec,
                                                     float (&w)[4]) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(W + off + cols[0]);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    w[0] = __low2float(lo); w[1] = __high2float(lo);
    w[2] = __low2float(hi); w[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = cols[c] >= 0 ? __bfloat162float(W[off + cols[c]]) : 0.f;
  }
}

// acc[r][c] += sum over k in [k0, k1) of rnd(in[r][k]) * W[k][cols[c]], in k
// order.  With a row stride and k0 that are multiples of 4 the inputs come
// from shared memory four k at a time.
template <typename WT>
__device__ __forceinline__ void dot4(const WT* __restrict__ W, int ldw, const int (&cols)[4],
                                     bool vec, int k0, int k1, const float* in, int in_stride,
                                     float (&acc)[ROWS][4]) {
  int k = k0;
  if ((in_stride & 3) == 0 && (k0 & 3) == 0) {
    for (; k + 4 <= k1; k += 4) {
      float w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4<WT>(W, (size_t)(k + i) * ldw, cols, vec, w[i]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x4 = *reinterpret_cast<const float4*>(in + r * in_stride + k);
        const float x[4] = {rnd<WT>(x4.x), rnd<WT>(x4.y), rnd<WT>(x4.z), rnd<WT>(x4.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[i], w[i][c], acc[r][c]);
      }
    }
  }
  for (; k < k1; ++k) {
    float w[4];
    load4<WT>(W, (size_t)k * ldw, cols, vec, w);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float x = rnd<WT>(in[r * in_stride + k]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x, w[c], acc[r][c]);
    }
  }
}

// out[r][j] = sum_k rnd(in[r][k]) * W[k][col(j)] for this block's ncols
// columns, col(j) = (j / seg) * seg_stride + base + j % seg.
//
// A warp owns 32 consecutive columns as 8 groups of 4 (one 16-byte load
// per lane and k when the group is aligned) and splits K four ways across
// its lanes (reduced with shuffles); when the slice has fewer column tiles
// than warps, K is split across warps too and the partial sums are added
// through shared memory.  Every sum runs in a fixed order.  Ends with the
// block synchronized.
template <typename WT>
__device__ void matvec_cols(const WT* __restrict__ W, int ldw, int K, const float* in,
                            int in_stride, int ncols, int seg, int seg_stride, int base,
                            float* part, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = cdiv(ncols, 32);
  const int kw = ncols > 0 ? max(1, min(NWARPS / max(tiles, 1), NT / ncols)) : 1;
  const int kcw = (cdiv(K, kw) + 3) & ~3;
  const int g = lane & 7, kq = lane >> 3;
  for (int wu = warp; wu < tiles * kw; wu += NWARPS) {
    const int ct = wu % tiles, kwi = wu / tiles;
    const int j = ct * 32 + g * 4;
    int cols[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cols[c] = j + c < ncols ? ((j + c) / seg) * seg_stride + base + (j + c) % seg : -1;
    const bool vec = cols[3] == cols[0] + 3 && (cols[0] & 3) == 0 && (ldw & 3) == 0;
    const int kw0 = min(K, kwi * kcw), kw1 = min(K, kw0 + kcw);
    const int kcl = (cdiv(kw1 - kw0, 4) + 3) & ~3;
    const int k0 = min(kw1, kw0 + kq * kcl), k1 = min(kw1, k0 + kcl);
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    if (cols[0] >= 0) dot4<WT>(W, ldw, cols, vec, k0, k1, in, in_stride, acc);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[r][c];
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[r][c] = a;
      }
    if (kq == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < ncols) part[(kwi * ROWS + r) * ncols + j + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * ncols; i += NT) {
    const int r = i / ncols, jj = i - r * ncols;
    float s = 0.f;
    for (int k = 0; k < kw; ++k) s += part[(k * ROWS + r) * ncols + jj];
    out[i] = s;
  }
  __syncthreads();
}

// Energies, masked softmax and (direct branch) the context rows of the step
// input, for every row of the tile; every block of the cluster computes
// them (bit-identically) from the gathered query.
template <typename WT>
__device__ void attention(const DecoderArgs& D, float* sm, const Layout& Lo, int d,
                          const float* mask, int row0, int B, int T) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int A = D.A, E = D.E, Kx = step_input_width(D);
  const WT* keys = static_cast<const WT*>(D.keys);
  const float* q = sm + Lo.q[d];
  float* att = sm + Lo.att[d];
  float* x = sm + Lo.x[d];

  for (int p = warp; p < ROWS * T; p += NWARPS) {
    const int r = p / T, t = p - r * T;
    const int row = min(row0 + r, B - 1);
    const size_t kbase = ((size_t)row * T + t) * A;
    float s = 0.f;
    for (int a = lane; a < A; a += 32)
      s += tanhf(ld(keys, kbase + a) + q[r * A + a]) * D.w_row[a];
    s = warp_sum(s);
    if (lane == 0) att[r * T + t] = mask[(size_t)row * T + t] > 0.f ? s : NEG;
  }
  __syncthreads();
  for (int r = warp; r < ROWS; r += NWARPS) {
    const int row = min(row0 + r, B - 1);
    float* ar = att + r * T;
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, ar[t]);
    m = warp_max(m);
    if (!(m > NEG / 2)) m = 0.f;      // all-masked row: weights come out all zero
    float s = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = mask[(size_t)row * T + t] > 0.f ? expf(ar[t] - m) : 0.f;
      ar[t] = e;
      s += e;
    }
    const float denom = fmaxf(warp_sum(s), 1e-30f);
    for (int t = lane; t < T; t += 32) ar[t] = ar[t] / denom;
  }
  __syncthreads();
  if (!D.factored) {
    const WT* feats = static_cast<const WT*>(D.slab);
    const int F = D.F;
    for (int i = tid; i < ROWS * F; i += NT) {
      const int r = i / F, f = i - r * F;
      const int row = min(row0 + r, B - 1);
      float s = 0.f;
      for (int t = 0; t < T; ++t)
        s = fmaf(att[r * T + t], ld(feats, ((size_t)row * T + t) * F + f), s);
      x[r * Kx + E + f] = rnd<WT>(s);
    }
  }
}

// This block's gate units: the x-side and h-side sums over its columns,
// then the cell update (gates.cuh); the new h slice goes to every block of
// the cluster.
template <typename WT, int G>
__device__ void gates(const DecoderArgs& D, float* sm, const Layout& Lo, int d, cg::cluster_group& cluster,
                      int rank, int row0, int B, int T, int cur) {
  const int H = D.H, GH = G * H, Kx = step_input_width(D);
  const int U = cdiv(H, CL), u0 = rank * U, nu = max(0, min(H, u0 + U) - u0);
  const WT* P = static_cast<const WT*>(D.slab);
  float* ax = sm + Lo.ax;
  float* ah = sm + Lo.ah;
  float* h_cur = sm + Lo.h[d] + cur * ROWS * H;
  const int nxt_off = Lo.h[d] + (cur ^ 1) * ROWS * H;
  const float* att = sm + Lo.att[d];
  float* c = sm + Lo.c[d];

  matvec_cols<WT>(static_cast<const WT*>(D.wi), GH, Kx, sm + Lo.x[d], Kx, G * nu, nu, H, u0,
                  sm + Lo.part, ax);
  matvec_cols<WT>(static_cast<const WT*>(D.wh), GH, H, h_cur, H, G * nu, nu, H, u0,
                  sm + Lo.part, ah);
  for (int i = threadIdx.x; i < ROWS * nu; i += NT) {
    const int r = i / nu, u = i - r * nu, n = u0 + u;
    const int row = min(row0 + r, B - 1);
    float gv[G], gh[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      gv[g] = ax[r * G * nu + g * nu + u] + D.b_gates[g * H + n];
      if (D.factored) {       // context rows' preactivation: attention-weighted sum over P
        float s = 0.f;
        for (int t = 0; t < T; ++t)
          s = fmaf(att[r * T + t], ld(P, ((size_t)row * T + t) * GH + g * H + n), s);
        gv[g] += s;
      }
      gh[g] = ah[r * G * nu + g * nu + u] + (D.cell == MVC_CELL_GRU ? D.b_h[g * H + n] : 0.f);
      if (D.cell == MVC_CELL_LSTM) gv[g] += gh[g];
    }
    float cc = c[r * U + u];
    const float hn = gate_update(D.cell, gv, gh, h_cur[r * H + n], cc);
    c[r * U + u] = cc;
    for (int p = 0; p < CL; ++p) cluster.map_shared_rank(sm, p)[nxt_off + r * H + n] = hn;
  }
}

template <typename WT>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
dual_greedy_kernel(const DualGreedyArgs args) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = args.B, T = args.T, V = args.V;
  const int row0 = (blockIdx.x / CL) * ROWS;
  const Layout Lo = layout(args);
  int* prev = reinterpret_cast<int*>(sm + Lo.prev);
  int* gather_i = reinterpret_cast<int*>(sm + Lo.gather_i);
  int* red_i = reinterpret_cast<int*>(sm + Lo.red_i);

#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const DecoderArgs& D = args.dec[d];
    for (int i = tid; i < ROWS * D.H; i += NT) sm[Lo.h[d] + i] = 0.f;
    for (int i = tid; i < ROWS * cdiv(D.H, CL); i += NT) sm[Lo.c[d] + i] = 0.f;
  }
  if (tid < 2 * ROWS) prev[tid] = args.sos_id;
  if (rank == 0 && tid < ROWS && row0 + tid < B)
    args.tokens[(size_t)(row0 + tid) * args.max_len] = 0;
  cluster.sync();                      // every peer is running before any remote write

  const int Vc = cdiv(V, CL), v0 = rank * Vc, v1 = min(V, v0 + Vc);
  for (int step = 0; step < args.max_len - 1; ++step) {
    const int cur = step & 1;

    // -- embeddings of each decoder's own previous token; this block's
    //    slice of the attention query, gathered into every peer
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const DecoderArgs& D = args.dec[d];
      const WT* emb = static_cast<const WT*>(D.emb);
      const int E = D.E, Kx = step_input_width(D), H = D.H, A = D.A;
      for (int i = tid; i < ROWS * E; i += NT) {
        const int r = i / E, k = i - r * E;
        sm[Lo.x[d] + r * Kx + k] = ld(emb, (size_t)prev[d * ROWS + r] * E + k);
      }
      const int Ac = cdiv(A, CL), a0 = rank * Ac, na = max(0, min(A, a0 + Ac) - a0);
      float* qs = sm + Lo.ax;          // scratch for the slice
      matvec_cols<WT>(static_cast<const WT*>(D.attn_W), A, H, sm + Lo.h[d] + cur * ROWS * H, H,
                      na, na, 0, a0, sm + Lo.part, qs);
      for (int i = tid; i < ROWS * na; i += NT) {
        const int r = i / na, a = i - r * na;
        const float v = qs[i] + D.attn_b[a0 + a];
        for (int p = 0; p < CL; ++p) cluster.map_shared_rank(sm, p)[Lo.q[d] + r * A + a0 + a] = v;
      }
      __syncthreads();
    }
    cluster.sync();

    // -- attention (every block, both decoders), then this block's gate units
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      attention<WT>(args.dec[d], sm, Lo, d, args.mask, row0, B, T);
      __syncthreads();
    }
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (args.dec[d].cell == MVC_CELL_LSTM)
        gates<WT, 4>(args.dec[d], sm, Lo, d, cluster, rank, row0, B, T, cur);
      else
        gates<WT, 3>(args.dec[d], sm, Lo, d, cluster, rank, row0, B, T, cur);
      __syncthreads();
    }
    cluster.sync();

    // -- this block's vocab slice of both projections; three running
    //    argmaxes per row (visual own, audio own, fused: s = 0, 1, 2)
    const DecoderArgs& Dv = args.dec[0];
    const DecoderArgs& Da = args.dec[1];
    const int nv = max(0, v1 - v0);
    float* lv = sm + Lo.logits;
    float* la = lv + ROWS * Vc;
    matvec_cols<WT>(static_cast<const WT*>(Dv.wout), V, Dv.H, sm + Lo.h[0] + (cur ^ 1) * ROWS * Dv.H,
                    Dv.H, nv, nv, 0, v0, sm + Lo.part, lv);
    matvec_cols<WT>(static_cast<const WT*>(Da.wout), V, Da.H, sm + Lo.h[1] + (cur ^ 1) * ROWS * Da.H,
                    Da.H, nv, nv, 0, v0, sm + Lo.part, la);
    float bval[3][ROWS];
    int bidx[3][ROWS];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { bval[s][r] = -INFINITY; bidx[s][r] = 0; }
    for (int j = tid; j < nv; j += NT) {
      const int v = v0 + j;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float a = lv[r * nv + j] + Dv.b_out[v];
        const float b = la[r * nv + j] + Da.b_out[v];
        const float f = a + b;
        // columns rise within a thread: a strictly larger value is needed
        if (a > bval[0][r]) { bval[0][r] = a; bidx[0][r] = v; }
        if (b > bval[1][r]) { bval[1][r] = b; bidx[1][r] = v; }
        if (f > bval[2][r]) { bval[2][r] = f; bidx[2][r] = v; }
      }
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        warp_argmax(bval[s][r], bidx[s][r]);
        if (lane == 0) {
          sm[Lo.red_v + warp * 3 * ROWS + s * ROWS + r] = bval[s][r];
          red_i[warp * 3 * ROWS + s * ROWS + r] = bidx[s][r];
        }
      }
    __syncthreads();
    if (tid < 3 * ROWS) {
      float bv = sm[Lo.red_v + tid];
      int bi = red_i[tid];
      for (int w = 1; w < NWARPS; ++w) {
        const float v = sm[Lo.red_v + w * 3 * ROWS + tid];
        const int i = red_i[w * 3 * ROWS + tid];
        if (better(v, i, bv, bi)) { bv = v; bi = i; }
      }
      for (int p = 0; p < CL; ++p) {
        float* peer = cluster.map_shared_rank(sm, p);
        peer[Lo.gather_v + rank * 3 * ROWS + tid] = bv;
        reinterpret_cast<int*>(peer + Lo.gather_i)[rank * 3 * ROWS + tid] = bi;
      }
    }
    cluster.sync();
    if (tid < 3 * ROWS) {             // every block reduces the same candidates in the same order
      float bv = sm[Lo.gather_v + tid];
      int bi = gather_i[tid];
      for (int p = 1; p < CL; ++p) {
        const float v = sm[Lo.gather_v + p * 3 * ROWS + tid];
        const int i = gather_i[p * 3 * ROWS + tid];
        if (better(v, i, bv, bi)) { bv = v; bi = i; }
      }
      const int s = tid / ROWS, r = tid - s * ROWS;
      if (s < 2) {
        prev[s * ROWS + r] = bi;
      } else if (rank == 0 && row0 + r < B) {
        args.tokens[(size_t)(row0 + r) * args.max_len + step + 1] = bi;
      }
    }
    __syncthreads();
  }
  cluster.sync();                      // no block leaves while a peer may still write to it
}

template <typename WT>
int launch(const DualGreedyArgs& a, cudaStream_t stream) {
  const size_t bytes = (size_t)layout(a).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dual_greedy_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = cdiv(a.B, ROWS) * CL;
  dual_greedy_kernel<WT><<<blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at these shapes (the wrapper checks
// it against the card's limit before launching).
size_t dual_greedy_smem_bytes(const DualGreedyArgs* args) {
  return (size_t)layout(*args).total * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int dual_greedy_launch(const DualGreedyArgs* args, int weight_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return weight_bf16 ? launch<__nv_bfloat16>(*args, s) : launch<float>(*args, s);
}

const char* dual_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
