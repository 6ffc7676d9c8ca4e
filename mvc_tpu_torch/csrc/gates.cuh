// Shared RNN gate update for the hand-written decode kernels.
//
// Replaces the TPU gate tile mvc_tpu/ops/_gates.py:apply_gate_tile.  One
// hidden unit's elementwise math; its plain PyTorch twin is
// mvc_tpu_torch/ops/_gates.py:apply_gates.  Torch gate order: LSTM i,f,g,o;
// GRU r,z,n with the recurrent n-bias kept inside the reset product.
#pragma once

#define MVC_CELL_LSTM 0
#define MVC_CELL_GRU 1

__device__ __forceinline__ float mvc_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// LSTM: gv[0..3] is the complete preactivation of gates i, f, g, o
//       (x-side + h-side + bi + bh); gh is unused; c is updated in place.
// GRU:  gv[0..2] = x-side + bi and gh[0..2] = h-side + bh of gates r, z, n;
//       h_prev is the previous hidden value; c is untouched.
// Returns the new hidden value.
__device__ __forceinline__ float gate_update(int cell, const float* gv, const float* gh,
                                             float h_prev, float& c) {
  if (cell == MVC_CELL_LSTM) {
    c = mvc_sigmoid(gv[1]) * c + mvc_sigmoid(gv[0]) * tanhf(gv[2]);
    return mvc_sigmoid(gv[3]) * tanhf(c);
  }
  const float r = mvc_sigmoid(gv[0] + gh[0]);
  const float z = mvc_sigmoid(gv[1] + gh[1]);
  const float n = tanhf(gv[2] + r * gh[2]);
  return (1.0f - z) * n + z * h_prev;
}
