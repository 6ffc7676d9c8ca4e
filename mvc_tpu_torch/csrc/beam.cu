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
// int32 [B, Lh + 1] = SOS, then beam 0's history (Lh = max_len + 1 steps),
// and per clip the steps it ran before it began a step with all its beams
// finished.
//
// What bounds it on this card: operations.  At the serving shape (B=64,
// W=5, T=16, max_len=30, V=4000, H=512, E=300, A=256) one step of one row
// is ~16 MFLOP of float32 matrix-vector work on ~41 MB of float32 weights:
// 320 rows x 31 steps is ~158 GFLOP, 2.4 ms at the 67 TFLOP/s float32
// (non-tensor-core) peak, against ~0.02 ms to read the weights once.
//
// What the design does about it: the cluster layout of decode_common.cuh
// (each block of a cluster of CL streams 1/CL of every weight's columns
// for the R rows of its tile).  The cross-beam step mixes the W rows of a
// clip, so a cluster owns whole clips: R / W of them.  Two tiles are
// built.  R = 15 holds three clips at the service's W = 5, so B = 64 needs
// 22 clusters: two waves of the 15 the card holds at once, where the 8-row
// tile (one clip, three padding rows) needs 64 clusters in five.  R = 8
// takes the clips too long for the 15-row tile's shared memory.  To fit 15
// rows the layout keeps one h per decoder: gates() writes a block's new
// units into a local staging slice, and after the cluster barrier every
// block pulls the CL slices into its h through distributed shared memory,
// 16 bytes a read; scratch regions live in disjoint phases share memory
// (layout()).  The vocabulary scoring never leaves the cluster: each block
// reduces its vocab slice to per-row lse partials and a local top-W, every
// block gathers all CL slices' partials through distributed shared memory
// and reduces them in the same order, so every block holds the same beams
// and makes the same selection.  The permutation is a shared-memory copy.
// Each clip counts its own steps; a cluster stops after the step that
// begins with all its clips' beams finished (a finished clip's later steps
// only write token 0 into beam 0's history).  wgmma, TMA and asynchronous
// copies are later steps.

#include <limits.h>

#include "decode_common.cuh"

struct BeamArgs {
  DecoderArgs dec[2];    // the first n_dec are read
  const float* mask;     // [B, T]: > 0 = attendable frame
  int* tokens;           // [B, Lh + 1] out
  int* steps;            // [B] out: steps the clip ran (null: not written)
  int B, T, V, W, Lh, n_dec, sos_id, eos_id;
  float alpha;           // GNMT length-norm exponent (0 = no norm)
  float inv6a;           // 6^-alpha, rounded to float
};

namespace {

constexpr float NEG_INF_SCORE = -1e9f;   // dead-beam start, as models/beam.py
constexpr int WIDE_ROWS = 15;            // the wide tile: three clips of W=5
constexpr int MAX_WIDTH = 8;             // 64-bit masks over CL*W and W*W candidates

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Shared-memory layout, in floats, identical in every block of a cluster.
struct Layout {
  int h[2], c[2], hs[2], q[2], x[2], att[2];   // per decoder (the first n_dec)
  int part, prev, cum, fin, eos, hist;
  int ax, ah, logits, tmp, cand_v, cand_i, lse, rc_n, rc_u, rc_t, sel_tok, sel_w, sel_cum;
  int total;
};

// The layout of an R-row tile; every region starts on a 16-byte boundary.
// First what lives across phases: the state, the staged h slices (pulled
// by the peers) and the query (written by the peers, possibly while this
// block still regathers the previous step), the split-K scratch.  Then one
// union of two groups that live in disjoint phases: x, att, ax, ah (embed,
// attention, gates) and the logits, candidates, lse partials and selection
// (vocab, selection, regather).  Peers write cand_v, cand_i and lse only
// between the gates' cluster barrier and the selection's, when every block
// has left the gates and none has begun the next embed, so the union needs
// no barrier of its own.  tmp, the regather's staging, reuses the logits.
__host__ __device__ inline Layout layout(const BeamArgs& a, int R) {
  Layout L = {};
  int o = 0, gc = 0, units = 0, sum_h = 0;
  for (int d = 0; d < a.n_dec; ++d) {
    const DecoderArgs& D = a.dec[d];
    const int U = cdiv(D.H, CL);
    L.h[d] = o;  o = round4(o + R * D.H);                          // [R][H] state
    L.c[d] = o;  o = round4(o + R * U);                            // [R][own units]
    L.hs[d] = o; o = round4(o + R * U);                            // [R][own units] new h
    L.q[d] = o;  o = round4(o + R * D.A);                          // [R][A]
    gc = imax(gc, gate_cols(D));
    units += U;
    sum_h += D.H;
  }
  const int Vc = cdiv(a.V, CL);
  L.part = o;    o = round4(o + R * imax(imax(gc, NT), Vc));       // split-K partial sums
  L.prev = o;    o = round4(o + R);                                // beam state per row
  L.cum = o;     o = round4(o + R);
  L.fin = o;     o = round4(o + R);
  L.eos = o;     o = round4(o + R);
  L.hist = o;    o = round4(o + R * a.Lh);                         // [R][Lh] tokens

  int u = o;                                                       // embed, attention, gates
  for (int d = 0; d < a.n_dec; ++d) {
    L.x[d] = u;   u = round4(u + R * step_input_width(a.dec[d]));  // [R][Kx] = [emb ; ctx]
    L.att[d] = u; u = round4(u + R * a.T);                         // [R][T]
  }
  L.ax = u;      u = round4(u + R * gc);                           // x-side gate sums
  L.ah = u;      u = round4(u + R * gc);                           // h-side gate sums

  int v = o;                                                       // vocab, selection, regather
  L.logits = v;                                                    // [n_dec][R][vocab slice]
  L.tmp = v;                                                       // [R][hist | c units | h]
  v = round4(v + imax(a.n_dec * R * Vc, R * (a.Lh + units + sum_h)));
  L.cand_v = v;  v = round4(v + CL * R * a.W);                     // every block's per-row top-W
  L.cand_i = v;  v = round4(v + CL * R * a.W);
  L.lse = v;     v = round4(v + CL * R * 4);                       // every block's (max, sum) per decoder
  L.rc_n = v;    v = round4(v + R * a.W);                          // a row's W candidates: normalized,
  L.rc_u = v;    v = round4(v + R * a.W);                          //   unnormalized score, token
  L.rc_t = v;    v = round4(v + R * a.W);
  L.sel_tok = v; v = round4(v + R);                                // the clip's selection per row
  L.sel_w = v;   v = round4(v + R);
  L.sel_cum = v; v = round4(v + R);
  L.total = imax(u, v);
  return L;
}

// Decoder d's h in this block <- the CL blocks' staged slices of the new
// state, through distributed shared memory (16-byte reads when every slice
// is whole and aligned).  The caller synchronizes the block afterwards.
template <int R>
__device__ void pull_h(int H, float* sm, const Layout& Lo, int d, cg::cluster_group& cluster) {
  const int U = cdiv(H, CL);
  float* h = sm + Lo.h[d];
  if (H % (4 * CL) == 0) {
    const int U4 = U / 4, H4 = H / 4;
    for (int i = threadIdx.x; i < R * H4; i += NT) {
      const int r = i / H4, j = i - r * H4, p = j / U4;
      const float4* src =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(sm + Lo.hs[d], p));
      reinterpret_cast<float4*>(h)[i] = src[r * U4 + j - p * U4];
    }
  } else {
    for (int i = threadIdx.x; i < R * H; i += NT) {
      const int r = i / H, n = i - r * H, p = n / U;
      h[i] = cluster.map_shared_rank(sm + Lo.hs[d], p)[r * U + n - p * U];
    }
  }
}

template <typename WT, int R>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 1)
beam_kernel(const BeamArgs args) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = args.B, T = args.T, V = args.V, W = args.W, Lh = args.Lh, n_dec = args.n_dec;
  const int ncl = R / W;                          // clips per cluster
  const int nrows = ncl * W;                      // rows of whole clips
  const int clip0 = (blockIdx.x / CL) * ncl;
  const int nclips = max(0, min(ncl, B - clip0)); // clips < B
  const Layout Lo = layout(args, R);
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
    for (int i = tid; i < R * D.H; i += NT) sm[Lo.h[d] + i] = 0.f;
    for (int i = tid; i < R * cdiv(D.H, CL); i += NT) sm[Lo.c[d] + i] = 0.f;
  }
  for (int i = tid; i < R * Lh; i += NT) hist[i] = 0;
  if (tid < R) {
    prev[tid] = args.sos_id;
    cum[tid] = tid % W == 0 ? 0.f : NEG_INF_SCORE;   // only beam 0 is live at the start
    fin[tid] = 0;
    eos[tid] = 0;
  }
  cluster.sync();                      // every peer is running before any remote access

  const int Vc = cdiv(V, CL), v0 = rank * Vc, nv = max(0, min(V, v0 + Vc) - v0);
  int t = 0;
  int clip_steps = 0;                  // thread c < nclips: its clip's steps, once known
  while (t < Lh) {
    // -- the clips that begin this step with all their beams finished
    //    (every block reads the same flags)
    bool began_allfin = true;
    for (int c = 0; c < nclips; ++c) {
      bool done = true;
      for (int w = 0; w < W; ++w) done = done && fin[c * W + w] != 0;
      if (done && c == tid && clip_steps == 0) clip_steps = t + 1;
      began_allfin = began_allfin && done;
    }

    // -- embeddings of the rows' previous tokens; this block's slice of
    //    each decoder's attention query, gathered into every peer
    for (int d = 0; d < n_dec; ++d)
      embed_and_query<WT, R>(args.dec[d], sm, Lo, d, prev, cluster, rank, 0);
    cluster.sync();

    // -- attention (every block), then this block's gate units, staged
    for (int d = 0; d < n_dec; ++d) {
      attention<WT, R>(args.dec[d], sm, Lo, d, args.mask, clip0, W, B, T);
      __syncthreads();
    }
    for (int d = 0; d < n_dec; ++d) {
      if (args.dec[d].cell == MVC_CELL_LSTM)
        gates<WT, 4, R, true>(args.dec[d], sm, Lo, d, cluster, rank, clip0, W, B, T, 0);
      else
        gates<WT, 3, R, true>(args.dec[d], sm, Lo, d, cluster, rank, clip0, W, B, T, 0);
      __syncthreads();
    }
    cluster.sync();

    // -- every block gathers the new state of every decoder
    for (int d = 0; d < n_dec; ++d) pull_h<R>(args.dec[d].H, sm, Lo, d, cluster);
    __syncthreads();

    // -- this block's vocab slice: logits of every decoder, then per row
    //    and decoder (max, sum of exp) and the fused logits in slot 0
    for (int d = 0; d < n_dec; ++d) {
      const DecoderArgs& D = args.dec[d];
      float* l = sm + Lo.logits + d * R * Vc;
      matvec_cols<WT, R>(static_cast<const WT*>(D.wout), V, D.H, sm + Lo.h[d], D.H, nv, nv, 0,
                         v0, sm + Lo.part, l);
      for (int i = tid; i < R * nv; i += NT) l[i] += D.b_out[v0 + i % nv];
    }
    __syncthreads();
    for (int rd = warp; rd < nrows * n_dec; rd += NWARPS) {   // one warp per (row, decoder)
      const int r = rd % nrows, d = rd / nrows;
      const float* l = sm + Lo.logits + d * R * Vc + r * nv;
      float m = -INFINITY;
      for (int j = lane; j < nv; j += 32) m = fmaxf(m, l[j]);
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < nv; j += 32) s += expf(l[j] - m);
      s = warp_sum(s);
      if (lane == 0)
        for (int p = 0; p < CL; ++p) {
          float* peer = cluster.map_shared_rank(sm, p);
          peer[Lo.lse + (rank * R + r) * 4 + 2 * d] = m;
          peer[Lo.lse + (rank * R + r) * 4 + 2 * d + 1] = s;
        }
    }
    __syncthreads();
    if (n_dec == 2)
      for (int i = tid; i < R * nv; i += NT) sm[Lo.logits + i] += sm[Lo.logits + R * Vc + i];
    __syncthreads();
    for (int r = warp; r < nrows; r += NWARPS) {   // one warp per row: W passes of argmax,
      float* f = sm + Lo.logits + r * nv;          // lowest index on ties
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
            peer[Lo.cand_v + (rank * R + r) * W + k] = bv;
            reinterpret_cast<int*>(peer + Lo.cand_i)[(rank * R + r) * W + k] = bi;
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
        for (int p = 0; p < CL; ++p) m = fmaxf(m, sm[Lo.lse + (p * R + r) * 4 + 2 * d]);
        float s = 0.f;
        for (int p = 0; p < CL; ++p) {
          const float sp = sm[Lo.lse + (p * R + r) * 4 + 2 * d + 1];
          if (sp > 0.f) s += sp * expf(sm[Lo.lse + (p * R + r) * 4 + 2 * d] - m);
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
          const float v = sm[Lo.cand_v + (p * R + r) * W + kk];
          const int i = cand_i[(p * R + r) * W + kk];
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

    // -- regather within each clip through tmp: the history, c and h of
    //    every decoder, the finished flags and EOS lengths; then this
    //    step's token.  Padding rows keep their own state.
    int c_off[2] = {0, 0}, h_off[2] = {0, 0};   // a staged row: [history | c units | h]
    int stride = Lh;
    for (int d = 0; d < n_dec; ++d) { c_off[d] = stride; stride += cdiv(args.dec[d].H, CL); }
    for (int d = 0; d < n_dec; ++d) { h_off[d] = stride; stride += args.dec[d].H; }
    float* tmp = sm + Lo.tmp;
    for (int i = tid; i < nrows * Lh; i += NT) {
      const int r = i / Lh, j = i - r * Lh;
      reinterpret_cast<int*>(tmp)[r * stride + j] = hist[i];
    }
    for (int d = 0; d < n_dec; ++d) {
      const int H = args.dec[d].H, U = cdiv(H, CL);
      for (int i = tid; i < nrows * U; i += NT) {
        const int r = i / U, u = i - r * U;
        tmp[r * stride + c_off[d] + u] = sm[Lo.c[d] + i];
      }
      for (int i = tid; i < nrows * H; i += NT) {
        const int r = i / H, n = i - r * H;
        tmp[r * stride + h_off[d] + n] = sm[Lo.h[d] + i];
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
      for (int i = tid; i < nrows * H; i += NT) {
        const int r = i / H, n = i - r * H;
        const int src = (r / W) * W + sel_w[r];
        sm[Lo.h[d] + i] = tmp[src * stride + h_off[d] + n];
      }
      for (int i = tid; i < nrows * U; i += NT) {
        const int r = i / U, u = i - r * U;
        const int src = (r / W) * W + sel_w[r];
        sm[Lo.c[d] + i] = tmp[src * stride + c_off[d] + u];
      }
    }
    for (int i = tid; i < nrows * Lh; i += NT) {
      const int r = i / Lh, j = i - r * Lh;
      const int src = (r / W) * W + sel_w[r];
      hist[i] = j == t ? sel_tok[r] : reinterpret_cast<const int*>(tmp)[src * stride + j];
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
    for (int i = tid; i < nclips * (Lh + 1); i += NT) {
      const int c = i / (Lh + 1), j = i - c * (Lh + 1);
      args.tokens[(size_t)(clip0 + c) * (Lh + 1) + j] = j == 0 ? args.sos_id : hist[c * W * Lh + j - 1];
    }
    if (args.steps != nullptr && tid < nclips) args.steps[clip0 + tid] = clip_steps ? clip_steps : t;
  }
  cluster.sync();                      // no block leaves while a peer may still access it
}

size_t smem_bytes(const BeamArgs& a, int R) { return (size_t)layout(a, R).total * sizeof(float); }

// The tile a launch takes at these shapes: the wide one when its layout
// fits a block's shared memory and holds more whole clips than ROWS rows
// do, else ROWS when that fits, else 0 (the wrapper raises).
int tile_rows(const BeamArgs& a) {
  if (smem_bytes(a, WIDE_ROWS) <= SMEM_LIMIT && WIDE_ROWS / a.W > ROWS / a.W) return WIDE_ROWS;
  return smem_bytes(a, ROWS) <= SMEM_LIMIT ? ROWS : 0;
}

template <typename WT, int R>
cudaError_t set_smem(const BeamArgs& a) {
  return cudaFuncSetAttribute(beam_kernel<WT, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(a, R));
}

template <typename WT, int R>
int launch(const BeamArgs& a, cudaStream_t stream) {
  cudaError_t err = set_smem<WT, R>(a);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<WT, R><<<cdiv(a.B, R / a.W) * CL, NT, smem_bytes(a, R), stream>>>(a);
  return (int)cudaGetLastError();
}

// Clusters of the kernel the card holds at once at these shapes (-1 when
// the query fails): with fewer than the grid's clusters, clusters run in
// waves.
template <typename WT, int R>
int max_active_clusters(const BeamArgs& a) {
  if (set_smem<WT, R>(a) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(a.B, R / a.W) * CL);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes(a, R);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, beam_kernel<WT, R>, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace

extern "C" {

// The row tile a launch with rows = 0 takes at these shapes: 15 or 8, or 0
// when neither fits a block's shared memory.
int beam_tile_rows(const BeamArgs* args) { return tile_rows(*args); }

// Dynamic shared memory one block needs at these shapes with an R-row tile
// (rows = 0: the tile beam_tile_rows picks, the 8-row one when none fits;
// the wrapper checks it against the card's limit before launching).
size_t beam_smem_bytes(const BeamArgs* args, int rows) {
  const int R = rows ? rows : tile_rows(*args);
  return smem_bytes(*args, R ? R : ROWS);
}

// The largest beam width the kernel takes, whatever the tile.
int beam_max_width(void) { return MAX_WIDTH; }

// Launches on `stream` with an R-row tile (rows = 0: beam_tile_rows's
// choice; otherwise 8 or 15); returns cudaGetLastError() (0 = launched).
int beam_launch(const BeamArgs* args, int weight_bf16, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = rows ? rows : tile_rows(*args);
  if (args->W < 1 || args->W > MAX_WIDTH) return (int)cudaErrorInvalidValue;
  if (R == WIDE_ROWS)
    return weight_bf16 ? launch<__nv_bfloat16, WIDE_ROWS>(*args, s)
                       : launch<float, WIDE_ROWS>(*args, s);
  if (R == ROWS)
    return weight_bf16 ? launch<__nv_bfloat16, ROWS>(*args, s) : launch<float, ROWS>(*args, s);
  return (int)cudaErrorInvalidValue;
}

int beam_max_active_clusters(const BeamArgs* args, int weight_bf16, int rows) {
  const int R = rows ? rows : tile_rows(*args);
  if (R == WIDE_ROWS)
    return weight_bf16 ? max_active_clusters<__nv_bfloat16, WIDE_ROWS>(*args)
                       : max_active_clusters<float, WIDE_ROWS>(*args);
  if (R == ROWS)
    return weight_bf16 ? max_active_clusters<__nv_bfloat16, ROWS>(*args)
                       : max_active_clusters<float, ROWS>(*args);
  return -1;
}

const char* beam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
