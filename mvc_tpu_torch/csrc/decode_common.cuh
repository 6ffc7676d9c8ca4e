// Building blocks of the whole-decode kernels (dual_greedy.cu, beam.cu).
//
// A thread-block cluster of CL blocks owns a tile of R decoder rows (a
// template parameter: ROWS = 8 for the greedy decodes, 8 or 15 for the
// beam search) and runs every step of the decode for them.  Each block of
// the cluster owns 1/CL of every weight's output columns (attention query,
// gate units, vocab slice) and streams only those, so a step's weights are
// read once per cluster, spread over CL SMs, and each load feeds R rows
// held in registers.  The hidden state and the attention query cross the cluster
// through distributed shared memory; the attention weights and the step
// input are recomputed by every block of the cluster (a few thousand
// operations per row).  Each lane loads four neighbouring columns of the
// row-major [in, out] weights at once and neighbouring lanes neighbouring
// groups, so loads are wide and coalesced; K is split across lanes and,
// for short slices, across warps.
//
// Row r of a tile reads the features of clip clip0 + r / rpc (rpc = rows
// per clip: 1 for the greedy decode, the beam width for a beam search),
// clamped to the last clip for the padding rows of a ragged last tile.
#pragma once

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

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int CL = 8;            // blocks per cluster
constexpr int ROWS = 8;          // rows per cluster tile (the default R)
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a Hopper block may opt into
                                        // (ops/_decode_common.py: MAX_SMEM_BYTES)
constexpr float NEG = -1e30f;    // masked energy, as the TPU kernels

template <typename WT>
__device__ __forceinline__ float ld(const WT* p, size_t i);
template <>
__device__ __forceinline__ float ld<float>(const float* p, size_t i) { return p[i]; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// The value a float takes once stored in the weight type (the TPU kernels'
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

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

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
// from shared memory four k at a time.  At R = 15 the accumulators leave
// ptxas a few spilled registers; taking two k at a time spills fewer but
// runs slower (PERF.md).
template <typename WT, int R>
__device__ __forceinline__ void dot4(const WT* __restrict__ W, int ldw, const int (&cols)[4],
                                     bool vec, int k0, int k1, const float* in, int in_stride,
                                     float (&acc)[R][4]) {
  int k = k0;
  if ((in_stride & 3) == 0 && (k0 & 3) == 0) {
    for (; k + 4 <= k1; k += 4) {
      float w[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4<WT>(W, (size_t)(k + i) * ldw, cols, vec, w[i]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
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
    for (int r = 0; r < R; ++r) {
      const float x = rnd<WT>(in[r * in_stride + k]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x, w[c], acc[r][c]);
    }
  }
}

// out[r][j] = sum_k rnd(in[r][k]) * W[k][col(j)] for the R rows and this
// block's ncols columns, col(j) = (j / seg) * seg_stride + base + j % seg.
// part holds R * max(NT, ncols) floats.
//
// A warp owns 32 consecutive columns as 8 groups of 4 (one 16-byte load
// per lane and k when the group is aligned) and splits K four ways across
// its lanes (reduced with shuffles); when the slice has fewer column tiles
// than warps, K is split across warps too and the partial sums are added
// through shared memory.  Every sum runs in a fixed order.  Ends with the
// block synchronized.
template <typename WT, int R = ROWS>
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
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    if (cols[0] >= 0) dot4<WT, R>(W, ldw, cols, vec, k0, k1, in, in_stride, acc);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[r][c];
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[r][c] = a;
      }
    if (kq == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < ncols) part[(kwi * R + r) * ncols + j + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R * ncols; i += NT) {
    const int r = i / ncols, jj = i - r * ncols;
    float s = 0.f;
    for (int k = 0; k < kw; ++k) s += part[(k * R + r) * ncols + jj];
    out[i] = s;
  }
  __syncthreads();
}

// The clip whose features row r of the tile reads.
__device__ __forceinline__ int row_clip(int clip0, int r, int rpc, int B) {
  return min(clip0 + r / rpc, B - 1);
}

// Energies, masked softmax and (direct branch) the context rows of the step
// input, for every row of the tile; every block of the cluster computes
// them (bit-identically) from the gathered query.  Lay is the kernel's
// shared-memory layout (offsets in floats: q, att, x per decoder).
template <typename WT, int R = ROWS, typename Lay>
__device__ void attention(const DecoderArgs& D, float* sm, const Lay& Lo, int d,
                          const float* mask, int clip0, int rpc, int B, int T) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int A = D.A, E = D.E, Kx = step_input_width(D);
  const WT* keys = static_cast<const WT*>(D.keys);
  const float* q = sm + Lo.q[d];
  float* att = sm + Lo.att[d];
  float* x = sm + Lo.x[d];

  for (int p = warp; p < R * T; p += NWARPS) {
    const int r = p / T, t = p - r * T;
    const int row = row_clip(clip0, r, rpc, B);
    const size_t kbase = ((size_t)row * T + t) * A;
    float s = 0.f;
    for (int a = lane; a < A; a += 32)
      s += tanhf(ld(keys, kbase + a) + q[r * A + a]) * D.w_row[a];
    s = warp_sum(s);
    if (lane == 0) att[r * T + t] = mask[(size_t)row * T + t] > 0.f ? s : NEG;
  }
  __syncthreads();
  for (int r = warp; r < R; r += NWARPS) {
    const int row = row_clip(clip0, r, rpc, B);
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
    for (int i = tid; i < R * F; i += NT) {
      const int r = i / F, f = i - r * F;
      const int row = row_clip(clip0, r, rpc, B);
      float s = 0.f;
      for (int t = 0; t < T; ++t)
        s = fmaf(att[r * T + t], ld(feats, ((size_t)row * T + t) * F + f), s);
      x[r * Kx + E + f] = rnd<WT>(s);
    }
  }
}

// This block's gate units: the x-side and h-side sums over its columns,
// then the cell update (gates.cuh).  Lay holds h, c ([R][own units]), x,
// att per decoder and the scratch part, ax, ah.  The new h slice goes
// either (STAGE false) to buffer cur ^ 1 of every block of the cluster (h
// is two [R][H] buffers), or (STAGE true) to this block's own staging
// slice hs ([R][ceil(H / CL)]), which the peers pull after the next
// cluster barrier (h is one [R][H] buffer, read here unchanged).
template <typename WT, int G, int R = ROWS, bool STAGE = false, typename Lay>
__device__ void gates(const DecoderArgs& D, float* sm, const Lay& Lo, int d,
                      cg::cluster_group& cluster, int rank, int clip0, int rpc, int B, int T,
                      int cur) {
  const int H = D.H, GH = G * H, Kx = step_input_width(D);
  const int U = cdiv(H, CL), u0 = rank * U, nu = max(0, min(H, u0 + U) - u0);
  const WT* P = static_cast<const WT*>(D.slab);
  float* ax = sm + Lo.ax;
  float* ah = sm + Lo.ah;
  float* h_cur = sm + Lo.h[d] + cur * R * H;
  const int nxt_off = Lo.h[d] + (cur ^ 1) * R * H;
  const float* att = sm + Lo.att[d];
  float* c = sm + Lo.c[d];

  matvec_cols<WT, R>(static_cast<const WT*>(D.wi), GH, Kx, sm + Lo.x[d], Kx, G * nu, nu, H, u0,
                     sm + Lo.part, ax);
  matvec_cols<WT, R>(static_cast<const WT*>(D.wh), GH, H, h_cur, H, G * nu, nu, H, u0,
                     sm + Lo.part, ah);
  for (int i = threadIdx.x; i < R * nu; i += NT) {
    const int r = i / nu, u = i - r * nu, n = u0 + u;
    const int row = row_clip(clip0, r, rpc, B);
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
    if constexpr (STAGE)
      sm[Lo.hs[d] + r * U + u] = hn;
    else
      for (int p = 0; p < CL; ++p) cluster.map_shared_rank(sm, p)[nxt_off + r * H + n] = hn;
  }
}

// The embedding of each row's previous token (prev[r]) into the step input,
// then this block's slice of the attention query, written into every block
// of the cluster.  Ends with the block synchronized; the caller syncs the
// cluster before the query is read.
template <typename WT, int R = ROWS, typename Lay>
__device__ void embed_and_query(const DecoderArgs& D, float* sm, const Lay& Lo, int d,
                                const int* prev, cg::cluster_group& cluster, int rank, int cur) {
  const WT* emb = static_cast<const WT*>(D.emb);
  const int E = D.E, Kx = step_input_width(D), H = D.H, A = D.A;
  for (int i = threadIdx.x; i < R * E; i += NT) {
    const int r = i / E, k = i - r * E;
    sm[Lo.x[d] + r * Kx + k] = ld(emb, (size_t)prev[r] * E + k);
  }
  const int Ac = cdiv(A, CL), a0 = rank * Ac, na = max(0, min(A, a0 + Ac) - a0);
  float* qs = sm + Lo.ax;          // scratch for the slice
  matvec_cols<WT, R>(static_cast<const WT*>(D.attn_W), A, H, sm + Lo.h[d] + cur * R * H, H,
                     na, na, 0, a0, sm + Lo.part, qs);
  for (int i = threadIdx.x; i < R * na; i += NT) {
    const int r = i / na, a = i - r * na;
    const float v = qs[i] + D.attn_b[a0 + a];
    for (int p = 0; p < CL; ++p) cluster.map_shared_rank(sm, p)[Lo.q[d] + r * A + a0 + a] = v;
  }
  __syncthreads();
}

}  // namespace
