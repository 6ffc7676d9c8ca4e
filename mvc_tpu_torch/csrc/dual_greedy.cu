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
// What bounds it on this card: the weights' trip from L2 to the FMAs.  At
// the serving shape (B=64, T=16, L=30, V=4000, H=512, E=300) one call does
// ~29.7 GFLOP of float32 matrix-vector work on ~41 MB of float32 weights:
// 0.44 ms at the 67 TFLOP/s float32 (non-tensor-core) peak, against ~0.02
// ms to read its bytes once.  The weights fit in the 50 MB L2, but every
// step needs every weight again: a block streams 4.00 MB of weight slices a
// step, the 64 blocks of B=64 254 MB.  The loads of the first design waited
// on L2 one at a time and every phase ended in block barriers (per-phase
// timers: 219 µs a step, 81 % of it in the matvecs).
//
// What the design does about it (greedy_common.cuh): a cluster of CL
// blocks owns ROWS batch rows and runs all steps of both decoders with no
// grid-wide sync; block rank r owns 1/CL of every weight's output columns,
// repacked by the wrapper into contiguous slices.  A producer warp streams
// the slices in a fixed order through a ring of shared-memory stages with
// cp.async.bulk, running ahead of the 16 consumer warps across phases and
// steps; the consumers read each weight once from shared memory and apply
// it to the 8 rows in registers.  Rank r attends over row r alone, its
// score rows in shared memory or, for clips too long for that, in a global
// workspace; the hidden state, the next query and the argmax candidates
// cross the cluster through distributed shared memory, with three cluster
// barriers a step.  wgmma (bf16) and more rows per weight load
// are later changes.

#include "greedy_common.cuh"

using DualGreedyArgs = GreedyArgsT<2>;   // dec = [visual, audio]

extern "C" {

// Dynamic shared memory one block needs at these shapes (the wrapper checks
// it against the card's limit before launching).
size_t dual_greedy_smem_bytes(const DualGreedyArgs* args) { return greedy_smem(*args); }

// Floats of the global workspace (args->ws) a launch needs at these shapes:
// 0 while the score rows fit shared memory.
size_t dual_greedy_workspace_floats(const DualGreedyArgs* args) { return greedy_workspace(*args); }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int dual_greedy_launch(const DualGreedyArgs* args, int weight_bf16, void* stream) {
  return greedy_launch_any(*args, weight_bf16, nullptr, stream);
}

// The same launch through the timed instantiation: per-phase clock64()
// marks of every step into `timer` (greedy_common.cuh: TIMER_HEAD +
// (max_len - 1) * N_MARKS int64).  For measurement only.
int dual_greedy_launch_timed(const DualGreedyArgs* args, int weight_bf16, long long* timer, void* stream) {
  return greedy_launch_any(*args, weight_bf16, timer, stream);
}

const char* dual_greedy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
