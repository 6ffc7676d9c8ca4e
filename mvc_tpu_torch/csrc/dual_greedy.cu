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
// grid-wide sync, with the column split of decode_common.cuh: a step's
// weights are read once per cluster, spread over CL SMs.  The new hidden
// state, the query and the argmax candidates are exchanged through
// distributed shared memory with one cluster barrier each.  The step's
// logits stay in shared memory (the block's vocab slice) and only argmax
// candidates leave the block.  wgmma, TMA and asynchronous copies are the
// next steps (a later change).

#include "decode_common.cuh"

struct DualGreedyArgs {
  DecoderArgs dec[2];    // [visual, audio]
  const float* mask;     // [B, T]: > 0 = attendable frame
  int* tokens;           // [B, max_len] out
  int B, T, max_len, V, sos_id;
};

namespace {

// Shared-memory layout, in floats, identical in every block of a cluster
// (distributed shared memory addresses a peer's copy by the same offset).
struct Layout {
  int h[2], c[2], x[2], q[2], att[2];   // per decoder
  int part, ax, ah, logits, gather_v, gather_i, red_v, red_i, prev, total;
};

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
    for (int d = 0; d < 2; ++d)
      embed_and_query<WT>(args.dec[d], sm, Lo, d, prev + d * ROWS, cluster, rank, cur);
    cluster.sync();

    // -- attention (every block, both decoders), then this block's gate units
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      attention<WT>(args.dec[d], sm, Lo, d, args.mask, row0, 1, B, T);
      __syncthreads();
    }
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (args.dec[d].cell == MVC_CELL_LSTM)
        gates<WT, 4>(args.dec[d], sm, Lo, d, cluster, rank, row0, 1, B, T, cur);
      else
        gates<WT, 3>(args.dec[d], sm, Lo, d, cluster, rank, row0, 1, B, T, cur);
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
