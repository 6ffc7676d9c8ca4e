// The free-running greedy decode of ND decoders (direct mode) in one
// launch: the step loop that greedy.cu (ND = 1) and dual_greedy.cu (ND = 2)
// instantiate.
//
// For L-1 steps each decoder embeds its OWN previous argmax, runs masked
// additive attention over T frames (over P = feats @ wi_ctx when the
// decoder is factored), applies the LSTM/GRU gates (gates.cuh) and projects
// onto the shared vocabulary.  Per row the kernel keeps S running argmaxes:
// one per decoder (its own feedback) and, with two decoders, one of the
// summed logits l_0 + l_1, which is the reported token; a single decoder's
// own argmax is its reported token.  Ties go to the lowest index.  Output:
// int32 [B, max_len], column 0 = 0.
//
// A cluster of CL blocks owns ROWS batch rows and runs every step for them
// with no grid-wide sync; block rank r owns 1/CL of every weight's output
// columns (attention query, gate units, vocab slice).  The query, the new
// hidden state and the argmax candidates cross the cluster through
// distributed shared memory with one cluster barrier each.
//
// The weights reach the FMAs through a ring of shared-memory stages.  The
// wrapper repacks every weight so that rank r's columns form one contiguous
// [K, columns] slice (ops/_decode_common.py: stream_operands).  One producer
// warp walks the block's weight stream, which is the same every step and
// does not depend on the data:
//   per decoder the gate slice of wi's step-input rows and of wh,
//   then per vocab chunk the vocab slice of wout of each decoder,
//   then the query slice of attn_W of each decoder (the next step's query
//   is taken from the new h right after the vocab),
// and copies it stage by stage with cp.async.bulk into the ring, completing
// on a "full" mbarrier.  It runs ahead across phase and step boundaries,
// held back only by the slots the consumers have not released yet (named
// barriers) and by the cluster barriers it must join.  The 16 consumer warps read each weight once from shared
// memory and apply it to the ROWS rows of the tile, whose inputs (h, x)
// were rounded to the weight type once, where they were written.  The
// consumers synchronise among themselves with a named barrier that the
// producer never joins.  Data-dependent reads stay with the consumers: the
// embedding rows of the previous tokens, the mask, and the per-row operands
// (attention keys, the factored slab P, the direct branch's features), read
// from global memory as the L2 holds them.
#pragma once

#include <stdint.h>

#include "decode_common.cuh"

// One decoder's weights as the stream reads them, repacked by the wrapper
// (CL slices each, rank r's at r; WT = the weight type).
struct StreamArgs {
  const void* q;      // [CL][Hp][ncq] WT: attn_W's query columns
  const void* wi;     // [CL][Kxp][ncg] WT: wi's gate columns, step-input rows
  const void* wh;     // [CL][Hp][ncg] WT: wh's gate columns
  const void* wout;   // [CL][nch][Hp][cw] WT: wout's vocab columns in chunks
  const float* bias;  // [CL][nb]: b_out (nch*cw) | b_gates (ncg) | b_h (ncg) | attn_b (Ap) | w_row (Ap)
};

template <int ND>
struct GreedyArgsT {
  DecoderArgs dec[ND];   // dual: [visual, audio]
  StreamArgs st[ND];
  const float* mask;     // [B, T]: > 0 = attendable frame
  int* tokens;           // [B, max_len] out
  int B, T, max_len, V, sos_id;
};

namespace {

constexpr int RB = 16;               // weight rows per row block (4 lanes x 4 rows)
constexpr int STAGE_BYTES = 32768;   // one ring stage
constexpr int MIN_STAGES = 2;        // the ring takes the shared memory that is left,
constexpr int MAX_STAGES = 6;        // within these bounds
constexpr int CHUNK = 512;           // widest column slice of one matvec (16 warps x 32)
constexpr int NTHREADS = NT + 32;    // NT consumer threads + the producer warp
constexpr size_t TOO_LARGE = (size_t)1 << 40;   // the need of shapes the kernel cannot take
static_assert(ROWS == CL, "block rank r attends over row r of the tile");

// Per-phase timers of the step loop (the TIMED instantiation only; see
// greedy_launch_timed).  Consumer thread 0 of block 0 (rank 0 of cluster 0)
// records clock64() at N_MARKS points of every step into timer[TIMER_HEAD +
// step * N_MARKS + m]; timer[0..3] hold %globaltimer (ns) and clock64()
// after the first cluster barrier and after the last, so the caller can
// convert cycles to time.  Marks: step start, then the ends of embed +
// the own row's attention, the attention cluster barrier, gates, the gates
// cluster barrier with the pull of h, the vocab matvec with the per-block
// argmax, the next step's query, and the candidate exchange + barrier.
constexpr int N_MARKS = 8;
constexpr int TIMER_HEAD = 4;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool TIMED>
__device__ __forceinline__ void mark(long long* timer, int i) {
  if constexpr (TIMED)
    if (blockIdx.x == 0 && threadIdx.x == 0) timer[i] = clock64();
}

template <bool TIMED>
__device__ __forceinline__ void mark_wall(long long* timer, int i) {
  if constexpr (TIMED)
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      timer[i] = global_ns();
      timer[i + 1] = clock64();
    }
}

// Running argmaxes per row: each decoder's own, plus the fused one when
// there are two or more decoders.  The reported token is the last stream.
template <int ND>
__host__ __device__ constexpr int n_streams() { return ND == 1 ? 1 : ND + 1; }

__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// K groups of a slice of ncp <= CHUNK columns: the warps left over when
// each of its 32-column tiles has one.
__host__ __device__ inline int k_groups(int ncp) { return NWARPS / cdiv(ncp, 32); }

// Weight rows per ring stage for a slice of ncp columns of wb-byte weights.
__host__ __device__ inline int stage_rows(int Kp, int ncp, int wb) {
  const int r = STAGE_BYTES / (ncp * wb) / RB * RB;
  return r < Kp ? r : Kp;
}

// One decoder's stream dimensions (ops/_decode_common.py: stream_dims).
struct SDims {
  int G, U, Ac, Vc, Hp, Kxp, ncq, ncg, nch, cw, Ap, nb;
};

__host__ __device__ inline SDims sdims(const DecoderArgs& D, int V) {
  SDims s;
  s.G = n_gates(D);
  s.U = cdiv(D.H, CL);
  s.Ac = cdiv(D.A, CL);
  s.Vc = cdiv(V, CL);
  s.Hp = round16(D.H);
  s.Kxp = round16(step_input_width(D));
  s.ncq = round8(s.Ac);
  s.ncg = round8(s.G * s.U);
  s.nch = cdiv(s.Vc, CHUNK);
  s.cw = round8(cdiv(s.Vc, s.nch));
  s.Ap = round4(D.A);
  s.nb = round4(s.nch * s.cw + 2 * s.ncg + 2 * s.Ap);
  return s;
}

// Offsets of the parts of the resident bias block (floats).
__host__ __device__ inline int bias_gates(const SDims& s) { return s.nch * s.cw; }
__host__ __device__ inline int bias_h(const SDims& s) { return s.nch * s.cw + s.ncg; }
__host__ __device__ inline int bias_q(const SDims& s) { return s.nch * s.cw + 2 * s.ncg; }
__host__ __device__ inline int bias_wrow(const SDims& s) { return s.nch * s.cw + 2 * s.ncg + s.Ap; }

// Shared-memory layout, in floats, identical in every block of a cluster
// (distributed shared memory addresses a peer's copy by the same offset).
// ops/_decode_common.py: greedy_layout is its Python replica.
template <int ND>
struct Layout {
  int h[ND], hs[ND], c[ND], x[ND], q[ND], att[ND], ps[ND], bias[ND];   // per decoder
  int part, px, pv, red_v, red_i, gather_v, gather_i, prev, bars, ring, stages;
  size_t bytes;   // > SMEM_LIMIT when the shapes do not fit
};

template <int ND>
__host__ __device__ inline Layout<ND> layout(const GreedyArgsT<ND>& a) {
  constexpr int S = n_streams<ND>();
  Layout<ND> L;
  int o = 0, pq = 0, pg = 0, pv = 0;
  bool gru = false, ok = true;
  for (int d = 0; d < ND; ++d) {
    const DecoderArgs& D = a.dec[d];
    const SDims s = sdims(D, a.V);
    ok = ok && s.ncq <= CHUNK && s.ncg <= CHUNK;
    L.h[d] = o;    o = round4(o + ROWS * s.Hp);      // [ROWS][Hp] h rounded to WT (the products' input)
    L.hs[d] = o;   o = round4(o + ROWS * s.U);       // [ROWS][U] own units of h, unrounded; peers pull it
    L.c[d] = o;    o = round4(o + ROWS * s.U);       // [ROWS][U] own units of c
    L.x[d] = o;    o = round4(o + ROWS * s.Kxp);     // [ROWS][Kxp] step input [emb ; ctx], rounded
    L.q[d] = o;    o = round4(o + D.A);              // [A] attention query of the block's own row
    L.att[d] = o;  o = round4(o + ROWS * a.T);       // [ROWS][T]
    L.ps[d] = o;   o = round4(o + (D.factored ? ROWS * s.ncg : 0));   // [ROWS][ncg] P-sums, factored
    L.bias[d] = o; o += s.nb;                        // resident biases and w_row
    const int q = k_groups(s.ncq) * ROWS * s.ncq, g = k_groups(s.ncg) * ROWS * s.ncg;
    pq = q > pq ? q : pq;
    pg = g > pg ? g : pg;
    pv = round4(k_groups(s.cw) * ROWS * s.cw);       // the decoders share V
    gru = gru || D.cell == MVC_CELL_GRU;
  }
  // split-K partial sums of one phase at a time: the gates' (h side, with
  // the x side beside it when a decoder is a GRU); one region of pv floats
  // per decoder for a vocab chunk or the query
  L.part = o;
  L.px = o + round4(pg);
  L.pv = pv > round4(pq) ? pv : round4(pq);
  const int need = round4(pg) * (gru ? 2 : 1);
  o += need > ND * L.pv ? need : ND * L.pv;
  L.red_v = o;    o = round4(o + NWARPS * S * ROWS);   // in-block argmax reduction
  L.red_i = o;    o = round4(o + NWARPS * S * ROWS);
  L.gather_v = o; o = round4(o + CL * S * ROWS);       // argmax candidates of every block
  L.gather_i = o; o = round4(o + CL * S * ROWS);
  L.prev = o;     o = round4(o + ND * ROWS);           // previous token per decoder, row
  L.bars = o;     o = round4(o + 2 * (MAX_STAGES + 1));   // full[] and bias mbarriers
  o = (o + 31) & ~31;                                  // the ring, 128-byte aligned
  L.ring = o;
  const size_t fixed = (size_t)o * sizeof(float);
  int st = fixed < SMEM_LIMIT ? (int)((SMEM_LIMIT - fixed) / STAGE_BYTES) : 0;
  st = st > MAX_STAGES ? MAX_STAGES : (st < MIN_STAGES ? MIN_STAGES : st);
  L.stages = st;
  L.bytes = ok ? fixed + (size_t)st * STAGE_BYTES : TOO_LARGE;
  return L;
}

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the completion of the barrier's phase of this parity.  A
// stream that never completes (a fault) traps after ~2^30 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try(bar, parity); ++n)
    if (n == (1u << 30)) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16, 16-byte aligned at both ends) from global memory
// into this block's shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The cluster barrier, split; every thread of the cluster takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The consumer warps' block barrier (named barrier 1; the producer warp
// never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NT) : "memory");
}

// Ring slot i is released by every consumer warp (bar.arrive) and taken
// back by the producer (bar.sync) on hardware named barrier 2 + i, whose
// NTHREADS arrivals complete it once per round.  (One mbarrier arrival per
// consumer warp and stage serialized on the barrier's word: about 0.3 µs
// a stage.)
__device__ __forceinline__ void slot_release(int slot) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 + slot), "n"(NTHREADS) : "memory");
}
__device__ __forceinline__ void slot_acquire(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(2 + slot), "n"(NTHREADS) : "memory");
}

// The "full" mbarrier of each ring slot and the one of the resident biases.
struct Bars {
  uint32_t base;
  __device__ uint32_t full(int i) const { return base + 8u * i; }
  __device__ uint32_t bias() const { return base + 8u * MAX_STAGES; }
};

// A position in the ring: the stage slot and the parity of its round.
struct RingPos {
  int slot;
  uint32_t phase;
  __device__ void next(int stages) {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// ------------------------------------------------------------ the producer

// The cluster barriers of the step loop, numbered in order: 0 before the
// loop, then 3 * step + 1 (attention weights), + 2 (gates) and + 3 (argmax
// candidates), and 3 * (max_len - 1) + 1 after it.  `need` is the barrier
// the consumers have passed before they read a segment: the producer joins
// every barrier up to it before it fills a stage of that segment, so it
// never holds the consumers back and runs at most one barrier ahead.
template <typename WT>
__device__ void produce_segment(const WT* src, int Kp, int ncp, int need, int& joined,
                                int& issued, const Bars& bars, uint32_t ring, int stages,
                                RingPos& pos) {
  const int lane = threadIdx.x & 31;
  while (joined < need) {
    cluster_wait();
    cluster_arrive();
    ++joined;
  }
  const int rows = stage_rows(Kp, ncp, (int)sizeof(WT));
  for (int k0 = 0; k0 < Kp; k0 += rows) {
    const uint32_t bytes = (uint32_t)(min(rows, Kp - k0) * ncp * (int)sizeof(WT));
    if (issued++ >= stages) slot_acquire(pos.slot);   // the consumers are done with its last round
    if (lane == 0) {
      mbar_expect_tx(bars.full(pos.slot), bytes);
      bulk_copy(ring + (uint32_t)pos.slot * STAGE_BYTES, src + (size_t)k0 * ncp, bytes,
                bars.full(pos.slot));
    }
    __syncwarp();
    pos.next(stages);
  }
}

template <typename WT, int ND>
__device__ void produce(const GreedyArgsT<ND>& a, const Layout<ND>& Lo, float* sm, int rank,
                        const Bars& bars) {
  const int lane = threadIdx.x & 31;
  const uint32_t ring = smem_addr(sm + Lo.ring);
  cluster_arrive();                    // barrier 0
  int joined = 0, issued = 0;
  SDims s[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) s[d] = sdims(a.dec[d], a.V);
  if (lane == 0) {                     // the resident biases, once
    uint32_t bytes = 0;
#pragma unroll
    for (int d = 0; d < ND; ++d) bytes += (uint32_t)s[d].nb * 4u;
    mbar_expect_tx(bars.bias(), bytes);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      bulk_copy(smem_addr(sm + Lo.bias[d]), a.st[d].bias + (size_t)rank * s[d].nb,
                (uint32_t)s[d].nb * 4u, bars.bias());
  }
  __syncwarp();
  RingPos pos{0, 0u};
  const int nch = s[0].nch;
  for (int step = 0; step < a.max_len - 1; ++step) {
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      produce_segment(static_cast<const WT*>(a.st[d].wi) + (size_t)rank * s[d].Kxp * s[d].ncg,
                      s[d].Kxp, s[d].ncg, 3 * step + 1, joined, issued, bars, ring,
                      Lo.stages, pos);
      produce_segment(static_cast<const WT*>(a.st[d].wh) + (size_t)rank * s[d].Hp * s[d].ncg,
                      s[d].Hp, s[d].ncg, 3 * step + 1, joined, issued, bars, ring,
                      Lo.stages, pos);
    }
    for (int c = 0; c < nch; ++c)
#pragma unroll
      for (int d = 0; d < ND; ++d)
        produce_segment(static_cast<const WT*>(a.st[d].wout) +
                            ((size_t)rank * nch + c) * s[d].Hp * s[d].cw,
                        s[d].Hp, s[d].cw, 3 * step + 2, joined, issued, bars, ring,
                      Lo.stages, pos);
    if (step + 2 < a.max_len) {        // the next step's query
#pragma unroll
      for (int d = 0; d < ND; ++d)
        produce_segment(static_cast<const WT*>(a.st[d].q) + (size_t)rank * s[d].Hp * s[d].ncq,
                        s[d].Hp, s[d].ncq, 3 * step + 2, joined, issued, bars, ring,
                      Lo.stages, pos);
    }
  }
  for (int i = 0; i < min(issued, Lo.stages); ++i) slot_acquire(i);   // the last round of each slot
  const int last = 3 * (a.max_len - 1) + 1;
  while (joined < last) {
    cluster_wait();
    cluster_arrive();
    ++joined;
  }
  cluster_wait();
}

// ----------------------------------------------------------- the consumers

// Four neighbouring elements at w (16-byte aligned for float, 8 for bf16).
template <typename WT>
__device__ __forceinline__ void ld4(const WT* w, float (&v)[4]);
template <>
__device__ __forceinline__ void ld4<float>(const float* w, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(w);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <>
__device__ __forceinline__ void ld4<__nv_bfloat16>(const __nv_bfloat16* w, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(w);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// acc[r][c] += sum over 4 rows i of in[r][i] * w[i][c]: w = 4 stage rows
// (stride ncp), in = the inputs' 4 matching k (row stride in_stride),
// already rounded to the weight type.
template <typename WT>
__device__ __forceinline__ void fma4(const WT* w, int ncp, const float* in, int in_stride,
                                     float (&acc)[ROWS][4]) {
  float wv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ld4<WT>(w + i * ncp, wv[i]);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float4 x4 = *reinterpret_cast<const float4*>(in + r * in_stride);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[i], wv[i][c], acc[r][c]);
  }
}

// Consumes one segment of the stream (Kp rows of ncp columns, in stages)
// into acc.  Warp w owns the 32 columns of tile w % tiles, and K group
// w / tiles takes every k_groups-th row block; within a warp, lane & 7 owns
// 4 neighbouring columns and lane >> 3 four rows of each row block.  Every
// consumer warp waits for every stage and releases it.
template <typename WT>
__device__ void consume(const float* in, int in_stride, int Kp, int ncp, const float* ring,
                        int stages, const Bars& bars, RingPos& pos, float (&acc)[ROWS][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = cdiv(ncp, 32), kw = NWARPS / tiles;
  const int kg = warp / tiles, j = (warp % tiles) * 32 + (lane & 7) * 4, kr = (lane >> 3) * 4;
  const bool on = kg < kw && j < ncp;
  const int rows = stage_rows(Kp, ncp, (int)sizeof(WT));
  int g = 0;                             // the K group of the next row block
  for (int k0 = 0; k0 < Kp; k0 += rows) {
    const int n = min(rows, Kp - k0);
    mbar_wait(bars.full(pos.slot), pos.phase);
    const WT* st = reinterpret_cast<const WT*>(ring + pos.slot * (STAGE_BYTES / 4));
    for (int b = 0; b < n; b += RB) {
      if (on && g == kg)
        fma4<WT>(st + (size_t)(b + kr) * ncp + j, ncp, in + k0 + b + kr, in_stride, acc);
      if (++g == kw) g = 0;
    }
    __syncwarp();
    slot_release(pos.slot);
    pos.next(stages);
  }
}

__device__ __forceinline__ void zero(float (&acc)[ROWS][4]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// Adds the four lanes of a column group (in a fixed order) and stores each
// K group's sums: part[(kg * ROWS + r) * ncp + col].
__device__ void store_partial(float (&acc)[ROWS][4], int ncp, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = cdiv(ncp, 32), kw = NWARPS / tiles;
  const int kg = warp / tiles, j = (warp % tiles) * 32 + (lane & 7) * 4;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float a = acc[r][c];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      acc[r][c] = a;
    }
  if ((lane >> 3) == 0 && kg < kw && j < ncp)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      *reinterpret_cast<float4*>(part + (kg * ROWS + r) * ncp + j) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The sum of the K groups' partials of (r, col), in group order.
__device__ __forceinline__ float sum_partial(const float* part, int ncp, int r, int col) {
  const int kw = k_groups(ncp);
  float s = 0.f;
  for (int k = 0; k < kw; ++k) s += part[(k * ROWS + r) * ncp + col];
  return s;
}

// The attention of the block's own row r = rank (ROWS == CL), for every
// decoder at once: energies over the T frames from its query, the masked
// softmax, and the context's share of the step: on the factored branch the
// attention-weighted sums of P (each block gets those of its gate units),
// on the direct branch the context part of the step input.  The weights
// and the context go into the peers, which read them after the next
// cluster barrier.  Ends with the consumers synchronized.
template <typename WT, int ND>
__device__ void attend_row(const GreedyArgsT<ND>& a, const SDims (&s)[ND], float* sm,
                           const Layout<ND>& Lo, int row0, int rank, cg::cluster_group& cluster) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, r = rank, row = min(row0 + r, a.B - 1);
  const float* mrow = a.mask + (size_t)row * T;
  for (int i = warp; i < ND * T; i += NWARPS) {        // (decoder, frame) pairs
    const int d = i / T, t = i - d * T, A = a.dec[d].A;
    const WT* keys = static_cast<const WT*>(a.dec[d].keys) + ((size_t)row * T + t) * A;
    const float* q = sm + Lo.q[d];
    const float* w_row = sm + Lo.bias[d] + bias_wrow(s[d]);
    float e = 0.f;
#pragma unroll 8
    for (int k = lane; k < A; k += 32) e += tanhf(ld(keys, k) + q[k]) * w_row[k];
    e = warp_sum(e);
    if (lane == 0) sm[Lo.att[d] + r * T + t] = mrow[t] > 0.f ? e : NEG;
  }
  consumers_sync();
  if (warp < ND) {
    float* ar = sm + Lo.att[warp] + r * T;
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, ar[t]);
    m = warp_max(m);
    if (!(m > NEG / 2)) m = 0.f;      // all-masked row: weights come out all zero
    float e = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float v = mrow[t] > 0.f ? expf(ar[t] - m) : 0.f;
      ar[t] = v;
      e += v;
    }
    const float denom = fmaxf(warp_sum(e), 1e-30f);
    for (int t = lane; t < T; t += 32) ar[t] = ar[t] / denom;
  }
  consumers_sync();
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const DecoderArgs& D = a.dec[d];
    const float* ar = sm + Lo.att[d] + r * T;
    if (D.factored) {   // the context's gate preactivations of row r, sent to each unit's block
      const int H = D.H, U = s[d].U, GH = s[d].G * H;
      const WT* P = static_cast<const WT*>(D.slab) + (size_t)row * T * GH;
      const int step = (H & 3) == 0 && (U & 3) == 0 ? 4 : 1;   // four columns of one block at once
      for (int c = step * tid; c < GH; c += step * NT) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (step == 4) {
#pragma unroll 8
          for (int t = 0; t < T; ++t) {
            float w[4];
            ld4<WT>(P + (size_t)t * GH + c, w);
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = fmaf(ar[t], w[k], v[k]);
          }
        } else {
#pragma unroll 8
          for (int t = 0; t < T; ++t) v[0] = fmaf(ar[t], ld(P, (size_t)t * GH + c), v[0]);
        }
        const int g = c / H, n = c - g * H, p = n / U, u = n - p * U;
        float* dst = cluster.map_shared_rank(sm, p) + Lo.ps[d] + r * s[d].ncg + g * U + u;
        if (step == 4)
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        else
          *dst = v[0];
      }
    } else {
      const WT* feats = static_cast<const WT*>(D.slab) + (size_t)row * T * D.F;
      const int F = D.F, xo = Lo.x[d] + r * s[d].Kxp + D.E;
      for (int f = tid; f < F; f += NT) {
        float v = 0.f;
#pragma unroll 8
        for (int t = 0; t < T; ++t) v = fmaf(ar[t], ld(feats, (size_t)t * F + f), v);
        v = rnd<WT>(v);
        for (int p = 0; p < CL; ++p) cluster.map_shared_rank(sm, p)[xo + f] = v;
      }
    }
    for (int i = tid; i < (CL - 1) * T; i += NT) {    // the weights into every peer
      const int p = (r + 1 + i / T) % CL, t = i % T;
      cluster.map_shared_rank(sm, p)[Lo.att[d] + r * T + t] = ar[t];
    }
  }
  consumers_sync();
}

// This block's gate units: the x-side and h-side sums over its columns from
// the stream, then the cell update (gates.cuh).  The new units go,
// unrounded, to this block's hs, which the peers pull after the cluster
// barrier.  Ends with the consumers synchronized.
template <typename WT, int ND>
__device__ void gate_units(const DecoderArgs& D, const SDims& s, float* sm, const Layout<ND>& Lo,
                           int d, int rank, const float* ring, int stages, const Bars& bars,
                           RingPos& pos) {
  const int H = D.H, U = s.U;
  const int u0 = rank * U, nu = max(0, min(H, u0 + U) - u0);
  const bool gru = D.cell == MVC_CELL_GRU;
  float acc[ROWS][4];
  zero(acc);
  consume<WT>(sm + Lo.x[d], s.Kxp, s.Kxp, s.ncg, ring, stages, bars, pos, acc);
  if (gru) {                            // the n gate keeps its x and h sides apart
    store_partial(acc, s.ncg, sm + Lo.px);
    zero(acc);
  }
  consume<WT>(sm + Lo.h[d], s.Hp, s.Hp, s.ncg, ring, stages, bars, pos, acc);
  store_partial(acc, s.ncg, sm + Lo.part);
  consumers_sync();
  const float* bias = sm + Lo.bias[d];
  float* hs = sm + Lo.hs[d];
  float* c = sm + Lo.c[d];
  for (int i = threadIdx.x; i < ROWS * nu; i += NT) {
    const int r = i / nu, u = i - r * nu;
    float gv[4], gh[4];
    for (int g = 0; g < s.G; ++g) {
      const int col = g * U + u;
      const float sh = sum_partial(sm + Lo.part, s.ncg, r, col);
      float v = (gru ? sum_partial(sm + Lo.px, s.ncg, r, col) : sh) + bias[bias_gates(s) + col];
      if (D.factored) v += sm[Lo.ps[d] + r * s.ncg + col];   // the context's part
      gv[g] = v;
      gh[g] = gru ? sh + bias[bias_h(s) + col] : 0.f;
    }
    float cc = c[r * U + u];
    const float hn = gate_update(D.cell, gv, gh, hs[r * U + u], cc);
    c[r * U + u] = cc;
    hs[r * U + u] = hn;
  }
  consumers_sync();
}

// Every row's h from the peers' hs slices, rounded to the weight type once.
template <typename WT>
__device__ void pull_h(const DecoderArgs& D, const SDims& s, float* sm, int h_off, int hs_off,
                       cg::cluster_group& cluster) {
  const int H = D.H, U = s.U;
  float* h = sm + h_off;
  if ((U & 3) == 0 && (H & 3) == 0) {
    const int H4 = H / 4;
    for (int i = threadIdx.x; i < ROWS * H4; i += NT) {
      const int r = i / H4, n = (i - r * H4) * 4, p = n / U, u = n - p * U;
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(sm, p) + hs_off + r * U + u);
      *reinterpret_cast<float4*>(h + r * s.Hp + n) =
          make_float4(rnd<WT>(v.x), rnd<WT>(v.y), rnd<WT>(v.z), rnd<WT>(v.w));
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * H; i += NT) {
      const int r = i / H, n = i - r * H, p = n / U, u = n - p * U;
      h[r * s.Hp + n] = rnd<WT>(cluster.map_shared_rank(sm, p)[hs_off + r * U + u]);
    }
  }
}

template <typename WT, int ND, bool TIMED>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NTHREADS, 1)
greedy_kernel(const GreedyArgsT<ND> args, long long* timer) {
  constexpr int S = n_streams<ND>();
  extern __shared__ __align__(128) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = args.B, V = args.V;
  const int row0 = (blockIdx.x / CL) * ROWS;
  const Layout<ND> Lo = layout(args);
  const Bars bars{smem_addr(sm + Lo.bars)};
  if (tid == 0) {
    for (int i = 0; i < Lo.stages; ++i) mbar_init(bars.full(i), 1);   // the producer's expect_tx
    mbar_init(bars.bias(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= NT) {                        // the producer warp
    produce<WT, ND>(args, Lo, sm, rank, bars);
    return;
  }

  SDims s[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) s[d] = sdims(args.dec[d], V);
  int* prev = reinterpret_cast<int*>(sm + Lo.prev);
  int* gather_i = reinterpret_cast<int*>(sm + Lo.gather_i);
  int* red_i = reinterpret_cast<int*>(sm + Lo.red_i);
  const float* ring = sm + Lo.ring;
#pragma unroll
  for (int d = 0; d < ND; ++d) {          // zero the state and the padding tails of h and x
    for (int i = tid; i < ROWS * s[d].Hp; i += NT) sm[Lo.h[d] + i] = 0.f;
    for (int i = tid; i < ROWS * s[d].U; i += NT) sm[Lo.hs[d] + i] = sm[Lo.c[d] + i] = 0.f;
    for (int i = tid; i < ROWS * s[d].Kxp; i += NT) sm[Lo.x[d] + i] = 0.f;
  }
  if (tid < ND * ROWS) prev[tid] = args.sos_id;
  if (rank == 0 && tid < ROWS && row0 + tid < B)
    args.tokens[(size_t)(row0 + tid) * args.max_len] = 0;
  cluster_sync();                         // barrier 0: every peer is running and zeroed
  mark_wall<TIMED>(timer, 0);
  mbar_wait(bars.bias(), 0);
#pragma unroll
  for (int d = 0; d < ND; ++d)            // h starts at 0: the first query is attn_b
    for (int a = tid; a < args.dec[d].A; a += NT) sm[Lo.q[d] + a] = sm[Lo.bias[d] + bias_q(s[d]) + a];
  consumers_sync();

  RingPos pos{0, 0u};
  const int Vc = s[0].Vc, v0 = rank * Vc, nch = s[0].nch, cw = s[0].cw;
  for (int step = 0; step < args.max_len - 1; ++step) {
    long long* tm = timer + TIMER_HEAD + step * N_MARKS;
    mark<TIMED>(tm, 0);

    // -- embeddings of each decoder's own previous token (every row); the
    //    attention of the block's own row, sent to every peer
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const DecoderArgs& D = args.dec[d];
      const WT* emb = static_cast<const WT*>(D.emb);
      for (int i = tid; i < ROWS * D.E; i += NT) {
        const int r = i / D.E, k = i - r * D.E;
        sm[Lo.x[d] + r * s[d].Kxp + k] = ld(emb, (size_t)prev[d * ROWS + r] * D.E + k);
      }
    }
    attend_row<WT, ND>(args, s, sm, Lo, row0, rank, cluster);
    mark<TIMED>(tm, 1);
    cluster_sync();
    mark<TIMED>(tm, 2);

    // -- this block's gate units; every row's new h pulled from the peers
#pragma unroll
    for (int d = 0; d < ND; ++d)
      gate_units<WT, ND>(args.dec[d], s[d], sm, Lo, d, rank, ring, Lo.stages, bars, pos);
    mark<TIMED>(tm, 3);
    cluster_sync();
#pragma unroll
    for (int d = 0; d < ND; ++d) pull_h<WT>(args.dec[d], s[d], sm, Lo.h[d], Lo.hs[d], cluster);
    consumers_sync();
    mark<TIMED>(tm, 4);

    // -- per vocab chunk, each decoder's logits of this block's columns; S
    //    running argmaxes per row (each decoder's own; with two decoders
    //    also the fused one), merged per warp into red
    for (int ch = 0; ch < nch; ++ch) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float acc[ROWS][4];
        zero(acc);
        consume<WT>(sm + Lo.h[d], s[d].Hp, s[d].Hp, cw, ring, Lo.stages, bars, pos, acc);
        store_partial(acc, cw, sm + Lo.part + d * Lo.pv);
      }
      consumers_sync();
      const int c0 = ch * cw, nv = max(0, min(cw, min(Vc - c0, V - v0 - c0)));
      float bval[S][ROWS];
      int bidx[S][ROWS];
#pragma unroll
      for (int k = 0; k < S; ++k)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) { bval[k][r] = -INFINITY; bidx[k][r] = 0; }
      for (int j = tid; j < nv; j += NT) {
        const int v = v0 + c0 + j;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float f = 0.f;
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            const float a =
                sum_partial(sm + Lo.part + d * Lo.pv, cw, r, j) + sm[Lo.bias[d] + c0 + j];
            f = d == 0 ? a : f + a;
            // columns rise within a thread: a strictly larger value is needed
            if (a > bval[d][r]) { bval[d][r] = a; bidx[d][r] = v; }
          }
          if (ND > 1 && f > bval[S - 1][r]) { bval[S - 1][r] = f; bidx[S - 1][r] = v; }
        }
      }
#pragma unroll
      for (int k = 0; k < S; ++k)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          warp_argmax(bval[k][r], bidx[k][r]);
          const int o = warp * S * ROWS + k * ROWS + r;
          if (lane == 0 &&
              (ch == 0 || better(bval[k][r], bidx[k][r], sm[Lo.red_v + o], red_i[o]))) {
            sm[Lo.red_v + o] = bval[k][r];
            red_i[o] = bidx[k][r];
          }
        }
      consumers_sync();
    }
    mark<TIMED>(tm, 5);

    // -- the next step's query from the new h: this block's columns of
    //    every row, each row's sent to the block that attends over it
    if (step + 2 < args.max_len) {
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float acc[ROWS][4];
        zero(acc);
        consume<WT>(sm + Lo.h[d], s[d].Hp, s[d].Hp, s[d].ncq, ring, Lo.stages, bars, pos, acc);
        store_partial(acc, s[d].ncq, sm + Lo.part + d * Lo.pv);
      }
      consumers_sync();
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int A = args.dec[d].A, a0 = rank * s[d].Ac, na = max(0, min(A, a0 + s[d].Ac) - a0);
        for (int i = tid; i < ROWS * na; i += NT) {
          const int r = i / na, k = i - r * na;
          cluster.map_shared_rank(sm, r)[Lo.q[d] + a0 + k] =
              sum_partial(sm + Lo.part + d * Lo.pv, s[d].ncq, r, k) +
              sm[Lo.bias[d] + bias_q(s[d]) + a0 + k];
        }
      }
    }
    mark<TIMED>(tm, 6);

    if (tid < S * ROWS) {
      float bv = sm[Lo.red_v + tid];
      int bi = red_i[tid];
      for (int w = 1; w < NWARPS; ++w) {
        const float v = sm[Lo.red_v + w * S * ROWS + tid];
        const int i = red_i[w * S * ROWS + tid];
        if (better(v, i, bv, bi)) { bv = v; bi = i; }
      }
      for (int p = 0; p < CL; ++p) {
        float* peer = cluster.map_shared_rank(sm, p);
        peer[Lo.gather_v + rank * S * ROWS + tid] = bv;
        reinterpret_cast<int*>(peer + Lo.gather_i)[rank * S * ROWS + tid] = bi;
      }
    }
    cluster_sync();
    if (tid < S * ROWS) {             // every block reduces the same candidates in the same order
      float bv = sm[Lo.gather_v + tid];
      int bi = gather_i[tid];
      for (int p = 1; p < CL; ++p) {
        const float v = sm[Lo.gather_v + p * S * ROWS + tid];
        const int i = gather_i[p * S * ROWS + tid];
        if (better(v, i, bv, bi)) { bv = v; bi = i; }
      }
      const int k = tid / ROWS, r = tid - k * ROWS;
      if (k < ND) prev[k * ROWS + r] = bi;
      if (k == S - 1 && rank == 0 && row0 + r < B)
        args.tokens[(size_t)(row0 + r) * args.max_len + step + 1] = bi;
    }
    consumers_sync();
    mark<TIMED>(tm, 7);
  }
  cluster_sync();                      // no block leaves while a peer may still read or write it
  mark_wall<TIMED>(timer, 2);
}

template <int ND>
size_t greedy_smem(const GreedyArgsT<ND>& a) {
  return layout(a).bytes;
}

template <typename WT, int ND, bool TIMED>
int greedy_launch_on(const GreedyArgsT<ND>& a, long long* timer, cudaStream_t stream) {
  const size_t bytes = greedy_smem(a);
  if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(greedy_kernel<WT, ND, TIMED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = cdiv(a.B, ROWS) * CL;
  greedy_kernel<WT, ND, TIMED><<<blocks, NTHREADS, bytes, stream>>>(a, timer);
  return (int)cudaGetLastError();
}

// Launches on `stream` with float32 or bfloat16 weights; returns
// cudaGetLastError() (0 = launched).  A non-null `timer` (int64,
// TIMER_HEAD + (max_len - 1) * N_MARKS entries) takes the timed
// instantiation, which records the per-phase clocks.
template <int ND>
int greedy_launch_any(const GreedyArgsT<ND>& a, int weight_bf16, long long* timer,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (timer)
    return weight_bf16 ? greedy_launch_on<__nv_bfloat16, ND, true>(a, timer, s)
                       : greedy_launch_on<float, ND, true>(a, timer, s);
  return weight_bf16 ? greedy_launch_on<__nv_bfloat16, ND, false>(a, nullptr, s)
                     : greedy_launch_on<float, ND, false>(a, nullptr, s);
}

}  // namespace
