// Whole dual-decoder greedy decode (direct mode) in one launch, for Hopper.
//
// Replaces the TPU kernel mvc_tpu/ops/pallas_dual_greedy.py:
// dual_greedy_decode_pallas (_dual_kernel / _dual_kernel_resident).  For
// L-1 steps each of the two decoders embeds its OWN previous argmax, runs
// masked additive attention over T frames (over P = feats @ wi_ctx when the
// decoder is factored), applies the LSTM/GRU gates (gates.cuh) and projects
// onto the shared vocabulary.  Three running argmaxes per row (visual,
// audio, fused l_v + l_a) break ties to the lowest index; the fused one is
// the reported token.  Output: int32 [B, max_len], column 0 = 0.  The step
// loop is greedy_common.cuh's, instantiated for two decoders.
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

#include "greedy_common.cuh"

using DualGreedyArgs = GreedyArgsT<2>;   // dec = [visual, audio]

extern "C" {

// Dynamic shared memory one block needs at these shapes (the wrapper checks
// it against the card's limit before launching).
size_t dual_greedy_smem_bytes(const DualGreedyArgs* args) { return greedy_smem(*args); }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int dual_greedy_launch(const DualGreedyArgs* args, int weight_bf16, void* stream) {
  return greedy_launch_any(*args, weight_bf16, stream);
}

const char* dual_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
