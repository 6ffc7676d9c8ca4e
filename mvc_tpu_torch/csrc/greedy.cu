// Whole single-decoder greedy decode (direct mode) in one launch, for Hopper.
//
// Replaces the TPU kernel mvc_tpu/ops/pallas_decode.py: greedy_decode_pallas
// (_decode_kernel streaming, _decode_kernel_resident whole-batch and
// grid-tiled; helpers _embed_prev, _attn_wsum): the direct-mode decode of
// the single-stream AVCaptioning over [audio | visual] features (F=2176).
// For L-1 steps the decoder embeds its own previous argmax, runs masked
// additive attention over T frames (over P = feats @ wi_ctx when it is
// factored, which it always is at F=2176 since F >= G*H), applies the
// LSTM/GRU gates (gates.cuh), projects onto the vocabulary and keeps one
// running argmax per row, lowest index on ties; that argmax is both the
// token and the next step's input.  Output: int32 [B, max_len], column
// 0 = 0.  The step loop is greedy_common.cuh's, instantiated for one
// decoder, so it shares every line of device code with dual_greedy.cu.
//
// What bounds it on this card: the weights' trip from L2 to the FMAs.  At
// B=64, T=16, L=30, V=4000, H=512, A=256, E=300, F=2176 (factored) a
// row-step is ~7.76 MFLOP (vocab 4.10, h-gates 2.10, x-gates 1.23, query
// 0.26, P-sum 0.07): 14.4 GFLOP in the kernel, 0.215 ms at the 67 TFLOP/s
// float32 (non-tensor-core) peak, against ~0.015 ms to read the call's ~49
// MB of inputs once.  The ~15 MB of float32 weights a step reads fit in
// the 50 MB L2, but every step reads them again: 1.93 MB of slices per
// block, 123 MB over the 64 blocks of B=64.
//
// What the design does about it: as dual_greedy.cu (greedy_common.cuh).
// A cluster of CL=8 blocks owns ROWS=8 batch rows for the whole decode; a
// producer warp streams each block's contiguous weight slices (query, gate
// units, vocab columns) through a shared-memory ring with cp.async.bulk and
// the consumer warps apply each weight, read once from shared memory, to
// the 8 rows; rank r attends over row r; h, the query and the argmax
// candidates cross the cluster through distributed shared memory, and
// every block reduces the gathered candidates in rank order, so all feed
// back the same token and rank 0 writes it.  wgmma and more than 64 SMs
// are later changes.

#include "greedy_common.cuh"

using GreedyArgs = GreedyArgsT<1>;

extern "C" {

// Dynamic shared memory one block needs at these shapes (the wrapper checks
// it against the card's limit before launching).
size_t greedy_smem_bytes(const GreedyArgs* args) { return greedy_smem(*args); }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int greedy_launch(const GreedyArgs* args, int weight_bf16, void* stream) {
  return greedy_launch_any(*args, weight_bf16, nullptr, stream);
}

// The same launch through the timed instantiation: per-phase clock64()
// marks of every step into `timer` (greedy_common.cuh: TIMER_HEAD +
// (max_len - 1) * N_MARKS int64).  For measurement only.
int greedy_launch_timed(const GreedyArgs* args, int weight_bf16, long long* timer, void* stream) {
  return greedy_launch_any(*args, weight_bf16, timer, stream);
}

const char* greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
