// Whole beam search over the summed log-probs of 1 or 2 decoders in one
// launch, for Hopper.
//
// Replaces the TPU kernel mvc_tpu/ops/pallas_beam.py: beam_decode_pallas
// (_beam_kernel, streaming and resident).  Rows are the B*W beams.  Each
// step every decoder embeds the row's previous token (one token feeds both
// decoders), runs masked additive attention over the clip's T frames (over
// P = feats @ wi_ctx when factored), applies the LSTM/GRU gates
// (gates.cuh) and projects onto the shared vocabulary.  Per row: a
// log-sum-exp per decoder and a top-W of the fused logits l_0 + l_1 (ties
// to the lowest token); a candidate's log-prob is its fused logit minus the
// summed lse.  Per clip: a top-W of the W*W candidates by GNMT-normalized
// score (ties to the lowest w*V + token); a finished beam offers tokens
// 0..W-1 at its cumulative score.  h, c, the token history, the finished
// flags and the EOS lengths are then permuted within the clip.  Output:
// int32 [B, Lh + 1] = SOS, then beam 0's history (Lh = max_len + 1 steps).
//
// What bounds it on this card: operations.  At the serving shape (B=64,
// W=5, T=16, max_len=30, V=4000, H=512, E=300, A=256) one step of one row
// is ~16 MFLOP of float32 matrix-vector work on ~41 MB of float32 weights:
// 320 rows x 31 steps is ~158 GFLOP, 2.4 ms at the 67 TFLOP/s float32
// (non-tensor-core) peak, against ~0.02 ms to read the weights once.
//
// What the design does about it: the cluster layout of decode_common.cuh
// (each block of a cluster of CL streams 1/CL of every weight's columns
// for ROWS rows).  The cross-beam step mixes the W rows of a clip, so a
// cluster owns whole clips: ROWS / W of them (one clip of W=5 in the 8-row
// tile).  The vocabulary scoring never leaves the cluster: each block
// reduces its vocab slice to per-row lse partials and a local top-W, every
// block gathers all CL slices' partials through distributed shared memory
// and reduces them in the same order, so every block holds the same beams
// and makes the same selection.  The permutation is a shared-memory copy.
// A cluster stops after the step that begins with all its clips' beams
// finished: later steps would only write token 0 into beam 0's history.
// wgmma, TMA and asynchronous copies are later steps.

#include <limits.h>

#include "decode_common.cuh"

struct BeamArgs {
  DecoderArgs dec[2];    // the first n_dec are read
  const float* mask;     // [B, T]: > 0 = attendable frame
  int* tokens;           // [B, Lh + 1] out
  int* steps;            // [B] out: steps the search ran for the clip's cluster
  int B, T, V, W, Lh, n_dec, sos_id, eos_id;
  float alpha;           // GNMT length-norm exponent (0 = no norm)
  float inv6a;           // 6^-alpha, rounded to float
};

namespace {

constexpr float NEG_INF_SCORE = -1e9f;   // dead-beam start, as models/beam.py

// Shared-memory layout, in floats, identical in every block of a cluster.
struct Layout {
  int h[2], c[2], x[2], q[2], att[2];   // per decoder (the first n_dec)
  int part, ax, ah, logits, cand_v, cand_i, lse, rc_n, rc_u, rc_t;
  int sel_tok, sel_w, sel_cum, prev, cum, fin, eos, hist, tmp, total;
};

__host__ __device__ inline Layout layout(const BeamArgs& a) {
  Layout L = {};
  int o = 0;
  int gc = 0, units = 0;
  for (int d = 0; d < a.n_dec; ++d) {
    const DecoderArgs& D = a.dec[d];
    L.h[d] = o;   o = round4(o + 2 * ROWS * D.H);                  // [2][ROWS][H]: state, new state
    L.c[d] = o;   o = round4(o + ROWS * cdiv(D.H, CL));            // [ROWS][own units]
    L.x[d] = o;   o = round4(o + ROWS * step_input_width(D));      // [ROWS][Kx] = [emb ; ctx]
    L.q[d] = o;   o = round4(o + ROWS * D.A);                      // [ROWS][A]
    L.att[d] = o; o = round4(o + ROWS * a.T);                      // [ROWS][T]
    gc = gate_cols(D) > gc ? gate_cols(D) : gc;
    units += cdiv(D.H, CL);
  }
  const int Vc = cdiv(a.V, CL);
  int pc = gc > NT ? gc : NT;
  pc = Vc > pc ? Vc : pc;
  L.part = o;    o = round4(o + ROWS * pc);                        // split-K partial sums
  L.ax = o;      o = round4(o + ROWS * gc);                        // x-side gate sums
  L.ah = o;      o = round4(o + ROWS * gc);                        // h-side gate sums
  L.logits = o;  o = round4(o + 2 * ROWS * Vc);                    // [2][ROWS][vocab slice]
  L.cand_v = o;  o = round4(o + CL * ROWS * a.W);                  // every block's per-row top-W
  L.cand_i = o;  o = round4(o + CL * ROWS * a.W);
  L.lse = o;     o = round4(o + CL * ROWS * 4);                    // every block's (max, sum) per decoder
  L.rc_n = o;    o = round4(o + ROWS * a.W);                       // a row's W candidates: normalized,
  L.rc_u = o;    o = round4(o + ROWS * a.W);                       //   unnormalized score, token
  L.rc_t = o;    o = round4(o + ROWS * a.W);
  L.sel_tok = o; o = round4(o + ROWS);                             // the clip's selection per row
  L.sel_w = o;   o = round4(o + ROWS);
  L.sel_cum = o; o = round4(o + ROWS);
  L.prev = o;    o = round4(o + ROWS);                             // beam state per row
  L.cum = o;     o = round4(o + ROWS);
  L.fin = o;     o = round4(o + ROWS);
  L.eos = o;     o = round4(o + ROWS);
  L.hist = o;    o = round4(o + ROWS * a.Lh);                      // [ROWS][Lh] tokens
  L.tmp = o;     o = round4(o + ROWS * (a.Lh + units));            // regather staging
  L.total = o;
  return L;
}

template <typename WT>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
beam_kernel(const BeamArgs args) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = args.B, T = args.T, V = args.V, W = args.W, Lh = args.Lh, n_dec = args.n_dec;
  const int ncl = ROWS / W;                       // clips per cluster
  const int nrows = ncl * W;                      // rows of whole clips
  const int clip0 = (blockIdx.x / CL) * ncl;
  const int live_rows = max(0, min(ncl, B - clip0)) * W;   // rows of clips < B
  const Layout Lo = layout(args);
  int* prev = reinterpret_cast<int*>(sm + Lo.prev);
  int* fin = reinterpret_cast<int*>(sm + Lo.fin);
  int* eos = reinterpret_cast<int*>(sm + Lo.eos);
  int* hist = reinterpret_cast<int*>(sm + Lo.hist);
  int* cand_i = reinterpret_cast<int*>(sm + Lo.cand_i);
  int* rc_t = reinterpret_cast<int*>(sm + Lo.rc_t);
  int* sel_tok = reinterpret_cast<int*>(sm + Lo.sel_tok);
  int* sel_w = reinterpret_cast<int*>(sm + Lo.sel_w);
  float* cum = sm + Lo.cum;

  for (int d = 0; d < n_dec; ++d) {
    const DecoderArgs& D = args.dec[d];
    for (int i = tid; i < ROWS * D.H; i += NT) sm[Lo.h[d] + i] = 0.f;
    for (int i = tid; i < ROWS * cdiv(D.H, CL); i += NT) sm[Lo.c[d] + i] = 0.f;
  }
  for (int i = tid; i < ROWS * Lh; i += NT) hist[i] = 0;
  if (tid < ROWS) {
    prev[tid] = args.sos_id;
    cum[tid] = tid % W == 0 ? 0.f : NEG_INF_SCORE;   // only beam 0 is live at the start
    fin[tid] = 0;
    eos[tid] = 0;
  }
  cluster.sync();                      // every peer is running before any remote write

  const int Vc = cdiv(V, CL), v0 = rank * Vc, nv = max(0, min(V, v0 + Vc) - v0);
  int t = 0;
  while (t < Lh) {
    bool began_allfin = true;          // every block reads the same flags
    for (int r = 0; r < live_rows; ++r) began_allfin = began_allfin && fin[r] != 0;

    // -- embeddings of the rows' previous tokens; this block's slice of
    //    each decoder's attention query, gathered into every peer
    for (int d = 0; d < n_dec; ++d)
      embed_and_query<WT>(args.dec[d], sm, Lo, d, prev, cluster, rank, 0);
    cluster.sync();

    // -- attention (every block), then this block's gate units; the new
    //    state goes to h buffer 1 of every peer
    for (int d = 0; d < n_dec; ++d) {
      attention<WT>(args.dec[d], sm, Lo, d, args.mask, clip0, W, B, T);
      __syncthreads();
    }
    for (int d = 0; d < n_dec; ++d) {
      if (args.dec[d].cell == MVC_CELL_LSTM)
        gates<WT, 4>(args.dec[d], sm, Lo, d, cluster, rank, clip0, W, B, T, 0);
      else
        gates<WT, 3>(args.dec[d], sm, Lo, d, cluster, rank, clip0, W, B, T, 0);
      __syncthreads();
    }
    cluster.sync();

    // -- this block's vocab slice: logits of every decoder, then per row
    //    and decoder (max, sum of exp) and the fused logits in slot 0
    for (int d = 0; d < n_dec; ++d) {
      const DecoderArgs& D = args.dec[d];
      float* l = sm + Lo.logits + d * ROWS * Vc;
      matvec_cols<WT>(static_cast<const WT*>(D.wout), V, D.H, sm + Lo.h[d] + ROWS * D.H, D.H,
                      nv, nv, 0, v0, sm + Lo.part, l);
      for (int i = tid; i < ROWS * nv; i += NT) l[i] += D.b_out[v0 + i % nv];
    }
    __syncthreads();
    if (warp < ROWS * n_dec) {          // one warp per (row, decoder)
      const int r = warp % ROWS, d = warp / ROWS;
      const float* l = sm + Lo.logits + d * ROWS * Vc + r * nv;
      float m = -INFINITY;
      for (int j = lane; j < nv; j += 32) m = fmaxf(m, l[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < nv; j += 32) s += expf(l[j] - m);
      s = warp_sum(s);
      if (lane == 0)
        for (int p = 0; p < CL; ++p) {
          float* peer = cluster.map_shared_rank(sm, p);
          peer[Lo.lse + (rank * ROWS + r) * 4 + 2 * d] = m;
          peer[Lo.lse + (rank * ROWS + r) * 4 + 2 * d + 1] = s;
        }
    }
    __syncthreads();
    if (n_dec == 2)
      for (int i = tid; i < ROWS * nv; i += NT) sm[Lo.logits + i] += sm[Lo.logits + ROWS * Vc + i];
    __syncthreads();
    if (warp < ROWS) {                  // one warp per row: W passes of argmax, lowest index on ties
      const int r = warp;
      float* f = sm + Lo.logits + r * nv;
      for (int k = 0; k < W; ++k) {
        float bv = -INFINITY;
        int bi = INT_MAX;
        for (int j = lane; j < nv; j += 32)      // columns rise within a lane
          if (f[j] > bv) { bv = f[j]; bi = v0 + j; }
        warp_argmax(bv, bi);
        bv = __shfl_sync(0xffffffffu, bv, 0);
        bi = __shfl_sync(0xffffffffu, bi, 0);
        if (lane == 0) {
          if (bi != INT_MAX) f[bi - v0] = -INFINITY;    // taken
          for (int p = 0; p < CL; ++p) {
            float* peer = cluster.map_shared_rank(sm, p);
            peer[Lo.cand_v + (rank * ROWS + r) * W + k] = bv;
            reinterpret_cast<int*>(peer + Lo.cand_i)[(rank * ROWS + r) * W + k] = bi;
          }
        }
        __syncwarp();
      }
    }
    cluster.sync();

    // -- every block, the same order: a row's top-W over the CL slices'
    //    candidates, its lse, and its W scored candidates
    if (tid < nrows) {
      const int r = tid;
      float lse = 0.f;
      for (int d = 0; d < n_dec; ++d) {
        float m = -INFINITY;
        for (int p = 0; p < CL; ++p) m = fmaxf(m, sm[Lo.lse + (p * ROWS + r) * 4 + 2 * d]);
        float s = 0.f;
        for (int p = 0; p < CL; ++p) {
          const float sp = sm[Lo.lse + (p * ROWS + r) * 4 + 2 * d + 1];
          if (sp > 0.f) s += sp * expf(sm[Lo.lse + (p * ROWS + r) * 4 + 2 * d] - m);
        }
        lse = lse + m + logf(s);
      }
      const bool f_r = fin[r] != 0;
      const float lens = f_r ? (float)eos[r] : (float)(t + 1);
      const float norm = args.alpha != 0.f ? expf(args.alpha * logf(5.f + lens)) * args.inv6a : 1.f;
      unsigned long long taken = 0ull;
      for (int k = 0; k < W; ++k) {
        float bv = -INFINITY;
        int bi = INT_MAX, bj = -1;
        for (int j = 0; j < CL * W; ++j) {
          const int p = j / W, kk = j - p * W;
          const float v = sm[Lo.cand_v + (p * ROWS + r) * W + kk];
          const int i = cand_i[(p * ROWS + r) * W + kk];
          if (i == INT_MAX || ((taken >> j) & 1ull)) continue;
          if (bj < 0 || better(v, i, bv, bi)) { bv = v; bi = i; bj = j; }
        }
        if (bj >= 0) taken |= 1ull << bj;
        const float cand = f_r ? cum[r] : cum[r] + (bv - lse);
        sm[Lo.rc_u + r * W + k] = cand;
        sm[Lo.rc_n + r * W + k] = args.alpha != 0.f ? cand / norm : cand;
        rc_t[r * W + k] = f_r ? k : bi;
      }
    }
    __syncthreads();

    // -- per clip: the top-W of its W*W candidates by normalized score,
    //    ties to the lowest w*V + token
    if (tid < ncl) {
      const int c = tid;
      unsigned long long taken = 0ull;
      for (int k = 0; k < W; ++k) {
        float bv = 0.f;
        int bg = INT_MAX, bj = -1;
        for (int j = 0; j < W * W; ++j) {
          if ((taken >> j) & 1ull) continue;
          const int w = j / W;
          const float v = sm[Lo.rc_n + c * W * W + j];
          const int g = w * V + rc_t[c * W * W + j];
          if (bj < 0 || better(v, g, bv, bg)) { bv = v; bg = g; bj = j; }
        }
        taken |= 1ull << bj;
        const int row = c * W + k;
        sel_w[row] = bj / W;
        sel_tok[row] = rc_t[c * W * W + bj];
        sm[Lo.sel_cum + row] = sm[Lo.rc_u + c * W * W + bj];
      }
    }
    __syncthreads();

    // -- regather within each clip: h (from the new-state buffer), c, the
    //    history, the finished flags and EOS lengths; then this step's token
    int u_off[2] = {0, 0};             // a staged row: [history | c units of each decoder]
    int tmp_stride = Lh;
    for (int d = 0; d < n_dec; ++d) { u_off[d] = tmp_stride; tmp_stride += cdiv(args.dec[d].H, CL); }
    float* tmp = sm + Lo.tmp;
    for (int i = tid; i < ROWS * Lh; i += NT) {
      const int r = i / Lh, j = i - r * Lh;
      reinterpret_cast<int*>(tmp)[r * tmp_stride + j] = hist[i];
    }
    for (int d = 0; d < n_dec; ++d) {
      const int U = cdiv(args.dec[d].H, CL);
      for (int i = tid; i < ROWS * U; i += NT) {
        const int r = i / U, u = i - r * U;
        tmp[r * tmp_stride + u_off[d] + u] = sm[Lo.c[d] + i];
      }
    }
    int src_fin = 0, src_eos = 0;
    if (tid < nrows) {
      const int src = (tid / W) * W + sel_w[tid];
      src_fin = fin[src];
      src_eos = eos[src];
    }
    __syncthreads();
    for (int d = 0; d < n_dec; ++d) {
      const int H = args.dec[d].H, U = cdiv(H, CL);
      const float* h_new = sm + Lo.h[d] + ROWS * H;
      float* h = sm + Lo.h[d];
      for (int i = tid; i < ROWS * H; i += NT) {
        const int r = i / H, n = i - r * H;
        const int src = r < nrows ? (r / W) * W + sel_w[r] : r;
        h[i] = h_new[src * H + n];
      }
      for (int i = tid; i < nrows * U; i += NT) {
        const int r = i / U, u = i - r * U;
        const int src = (r / W) * W + sel_w[r];
        sm[Lo.c[d] + i] = tmp[src * tmp_stride + u_off[d] + u];
      }
    }
    for (int i = tid; i < nrows * Lh; i += NT) {
      const int r = i / Lh, j = i - r * Lh;
      const int src = (r / W) * W + sel_w[r];
      hist[i] = j == t ? sel_tok[r] : reinterpret_cast<const int*>(tmp)[src * tmp_stride + j];
    }
    if (tid < nrows) {
      const int tok = sel_tok[tid];
      const bool is_eos = tok == args.eos_id;
      fin[tid] = (src_fin || is_eos) ? 1 : 0;
      eos[tid] = src_fin ? src_eos : (is_eos ? t + 1 : 0);
      cum[tid] = sm[Lo.sel_cum + tid];
      prev[tid] = tok;
    }
    __syncthreads();
    ++t;
    if (began_allfin) break;
  }

  if (rank == 0) {
    const int nclips = live_rows / W;
    for (int i = tid; i < nclips * (Lh + 1); i += NT) {
      const int c = i / (Lh + 1), j = i - c * (Lh + 1);
      args.tokens[(size_t)(clip0 + c) * (Lh + 1) + j] = j == 0 ? args.sos_id : hist[c * W * Lh + j - 1];
    }
    if (args.steps != nullptr && tid < nclips) args.steps[clip0 + tid] = t;
  }
  cluster.sync();                      // no block leaves while a peer may still write to it
}

template <typename WT>
int launch(const BeamArgs& a, cudaStream_t stream) {
  const size_t bytes = (size_t)layout(a).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(beam_kernel<WT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = cdiv(a.B, ROWS / a.W) * CL;
  beam_kernel<WT><<<blocks, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Clusters of the kernel the card holds at once at these shapes (-1 when
// the query fails): with fewer than the grid's clusters, clusters run in
// waves.
template <typename WT>
int max_active_clusters(const BeamArgs& a) {
  const size_t bytes = (size_t)layout(a).total * sizeof(float);
  if (cudaFuncSetAttribute(beam_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(a.B, ROWS / a.W) * CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, beam_kernel<WT>, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at these shapes (the wrapper checks
// it against the card's limit before launching).
size_t beam_smem_bytes(const BeamArgs* args) {
  return (size_t)layout(*args).total * sizeof(float);
}

// The largest beam width the kernel takes (a cluster owns whole clips).
int beam_max_width(void) { return ROWS; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int beam_launch(const BeamArgs* args, int weight_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return weight_bf16 ? launch<__nv_bfloat16>(*args, s) : launch<float>(*args, s);
}

int beam_max_active_clusters(const BeamArgs* args, int weight_bf16) {
  return weight_bf16 ? max_active_clusters<__nv_bfloat16>(*args) : max_active_clusters<float>(*args);
}

const char* beam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
