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
// with no grid-wide sync, with the column split of decode_common.cuh: a
// step's weights are read once per cluster, spread over CL SMs.  The new
// hidden state, the query and the argmax candidates cross the cluster
// through distributed shared memory with one cluster barrier each.  The
// step's logits stay in shared memory (the block's vocab slice); each block
// reduces its slice to one candidate per row and stream, writes it into
// every peer, and after the barrier every block reduces the CL gathered
// candidates in rank order, so all blocks feed back the same tokens.
#pragma once

#include "decode_common.cuh"

template <int ND>
struct GreedyArgsT {
  DecoderArgs dec[ND];   // dual: [visual, audio]
  const float* mask;     // [B, T]: > 0 = attendable frame
  int* tokens;           // [B, max_len] out
  int B, T, max_len, V, sos_id;
};

namespace {

// Running argmaxes per row: each decoder's own, plus the fused one when
// there are two or more decoders.  The reported token is the last stream.
template <int ND>
__host__ __device__ constexpr int n_streams() { return ND == 1 ? 1 : ND + 1; }

// Shared-memory layout, in floats, identical in every block of a cluster
// (distributed shared memory addresses a peer's copy by the same offset).
template <int ND>
struct Layout {
  int h[ND], c[ND], x[ND], q[ND], att[ND];   // per decoder
  int part, ax, ah, logits, gather_v, gather_i, red_v, red_i, prev, total;
};

// Every region starts on a 16-byte boundary (float4 reads of the inputs).
template <int ND>
__host__ __device__ inline Layout<ND> layout(const GreedyArgsT<ND>& a) {
  constexpr int S = n_streams<ND>();
  Layout<ND> L;
  int o = 0;
  int gc = 0;
  for (int d = 0; d < ND; ++d) {
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
  L.logits = o;   o = round4(o + ND * ROWS * cdiv(a.V, CL));        // [ND][ROWS][vocab slice]
  L.gather_v = o; o = round4(o + CL * S * ROWS);                   // argmax candidates of every block
  L.gather_i = o; o = round4(o + CL * S * ROWS);
  L.red_v = o;    o = round4(o + NWARPS * S * ROWS);               // in-block argmax reduction
  L.red_i = o;    o = round4(o + NWARPS * S * ROWS);
  L.prev = o;     o = round4(o + ND * ROWS);                       // previous token per decoder, row
  L.total = o;
  return L;
}

template <typename WT, int ND>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
greedy_kernel(const GreedyArgsT<ND> args) {
  constexpr int S = n_streams<ND>();
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = args.B, T = args.T, V = args.V;
  const int row0 = (blockIdx.x / CL) * ROWS;
  const Layout<ND> Lo = layout(args);
  int* prev = reinterpret_cast<int*>(sm + Lo.prev);
  int* gather_i = reinterpret_cast<int*>(sm + Lo.gather_i);
  int* red_i = reinterpret_cast<int*>(sm + Lo.red_i);

#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const DecoderArgs& D = args.dec[d];
    for (int i = tid; i < ROWS * D.H; i += NT) sm[Lo.h[d] + i] = 0.f;
    for (int i = tid; i < ROWS * cdiv(D.H, CL); i += NT) sm[Lo.c[d] + i] = 0.f;
  }
  if (tid < ND * ROWS) prev[tid] = args.sos_id;
  if (rank == 0 && tid < ROWS && row0 + tid < B)
    args.tokens[(size_t)(row0 + tid) * args.max_len] = 0;
  cluster.sync();                      // every peer is running before any remote write

  const int Vc = cdiv(V, CL), v0 = rank * Vc, v1 = min(V, v0 + Vc);
  for (int step = 0; step < args.max_len - 1; ++step) {
    const int cur = step & 1;

    // -- embeddings of each decoder's own previous token; this block's
    //    slice of the attention query, gathered into every peer
#pragma unroll
    for (int d = 0; d < ND; ++d)
      embed_and_query<WT>(args.dec[d], sm, Lo, d, prev + d * ROWS, cluster, rank, cur);
    cluster.sync();

    // -- attention (every block, every decoder), then this block's gate units
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      attention<WT>(args.dec[d], sm, Lo, d, args.mask, row0, 1, B, T);
      __syncthreads();
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      if (args.dec[d].cell == MVC_CELL_LSTM)
        gates<WT, 4>(args.dec[d], sm, Lo, d, cluster, rank, row0, 1, B, T, cur);
      else
        gates<WT, 3>(args.dec[d], sm, Lo, d, cluster, rank, row0, 1, B, T, cur);
      __syncthreads();
    }
    cluster.sync();

    // -- this block's vocab slice of every projection; S running argmaxes
    //    per row (each decoder's own; with two decoders also the fused one)
    const int nv = max(0, v1 - v0);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const DecoderArgs& D = args.dec[d];
      matvec_cols<WT>(static_cast<const WT*>(D.wout), V, D.H, sm + Lo.h[d] + (cur ^ 1) * ROWS * D.H,
                      D.H, nv, nv, 0, v0, sm + Lo.part, sm + Lo.logits + d * ROWS * Vc);
    }
    float bval[S][ROWS];
    int bidx[S][ROWS];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { bval[s][r] = -INFINITY; bidx[s][r] = 0; }
    for (int j = tid; j < nv; j += NT) {
      const int v = v0 + j;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float f = 0.f;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const float a = sm[Lo.logits + d * ROWS * Vc + r * nv + j] + args.dec[d].b_out[v];
          f = d == 0 ? a : f + a;
          // columns rise within a thread: a strictly larger value is needed
          if (a > bval[d][r]) { bval[d][r] = a; bidx[d][r] = v; }
        }
        if (ND > 1 && f > bval[S - 1][r]) { bval[S - 1][r] = f; bidx[S - 1][r] = v; }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        warp_argmax(bval[s][r], bidx[s][r]);
        if (lane == 0) {
          sm[Lo.red_v + warp * S * ROWS + s * ROWS + r] = bval[s][r];
          red_i[warp * S * ROWS + s * ROWS + r] = bidx[s][r];
        }
      }
    __syncthreads();
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
    cluster.sync();
    if (tid < S * ROWS) {             // every block reduces the same candidates in the same order
      float bv = sm[Lo.gather_v + tid];
      int bi = gather_i[tid];
      for (int p = 1; p < CL; ++p) {
        const float v = sm[Lo.gather_v + p * S * ROWS + tid];
        const int i = gather_i[p * S * ROWS + tid];
        if (better(v, i, bv, bi)) { bv = v; bi = i; }
      }
      const int s = tid / ROWS, r = tid - s * ROWS;
      if (s < ND) prev[s * ROWS + r] = bi;
      if (s == S - 1 && rank == 0 && row0 + r < B)
        args.tokens[(size_t)(row0 + r) * args.max_len + step + 1] = bi;
    }
    __syncthreads();
  }
  cluster.sync();                      // no block leaves while a peer may still write to it
}

template <int ND>
size_t greedy_smem(const GreedyArgsT<ND>& a) {
  return (size_t)layout(a).total * sizeof(float);
}

template <typename WT, int ND>
int greedy_launch_on(const GreedyArgsT<ND>& a, cudaStream_t stream) {
  const size_t bytes = greedy_smem(a);
  cudaError_t err = cudaFuncSetAttribute(greedy_kernel<WT, ND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = cdiv(a.B, ROWS) * CL;
  greedy_kernel<WT, ND><<<blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Launches on `stream` with float32 or bfloat16 weights; returns
// cudaGetLastError() (0 = launched).
template <int ND>
int greedy_launch_any(const GreedyArgsT<ND>& a, int weight_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return weight_bf16 ? greedy_launch_on<__nv_bfloat16, ND>(a, s)
                     : greedy_launch_on<float, ND>(a, s);
}

}  // namespace
