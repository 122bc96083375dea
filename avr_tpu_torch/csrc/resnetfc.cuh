// K2 definitions shared by the decoder's kernels (csrc/resnetfc.cu: the
// float32 forward and backward, and the bf16 forward outside the wgmma
// kernel's envelope; csrc/resnetfc_hopper.cu: the bf16
// forward and backward on wgmma and TMA): the stash and cotangent slot
// layouts and the forward's and the backward's arguments.
#pragma once

#include "common.cuh"

// Stash slot of block k's first (j = 0, relu(h)) or second (j = 1,
// relu(fc_0)) activation for view v; the pre-pool slots of one (k, j) are
// contiguous over views.  The last slot is relu(h_final), lin_out's input.
__host__ __device__ inline int stash_slot(int k, int j, int v, int ns, int n_lin_z) {
  return k < n_lin_z ? (2 * k + j) * ns + v : 2 * n_lin_z * ns + 2 * (k - n_lin_z) + j;
}
__host__ __device__ inline int stash_slots(int ns, int n_blocks, int n_lin_z) {
  return 2 * n_lin_z * ns + 2 * (n_blocks - n_lin_z) + 1;
}

// Cotangent slot of block k's products: j = 0 is fc_0's (pairs with stash
// slot (k, 0)), j = 1 fc_1's, which is also the trunk cotangent entering
// block k (pairs with stash slot (k, 1)).  After them, one slot per view
// for lin_in's output (the trunk cotangent after injection 0).
__host__ __device__ inline int cot_slots(int ns, int n_blocks, int n_lin_z) {
  return 2 * n_lin_z * ns + 2 * (n_blocks - n_lin_z) + ns;
}
__host__ __device__ inline int cot_in_slot(int v, int ns, int n_blocks, int n_lin_z) {
  return 2 * n_lin_z * ns + 2 * (n_blocks - n_lin_z) + v;
}

// The forward's arguments (csrc/resnetfc.cu: float32, and bf16 outside the
// wgmma kernel's envelope; csrc/resnetfc_hopper.cu: the bf16 wgmma forward).
struct FcArgs {
  const float* x;       // (ns, N, d_in) float32 raw (or already encoded) inputs
  const void* z;        // (ns, N, d_latent) T
  const void* wi;       // (dh, k_in) T, zero-padded columns
  const float* bi;      // (dh)
  const void* wz;       // (n_lin_z, dh, d_latent) T
  const float* bz;      // (n_lin_z, dh)
  const void* w0;       // (n_blocks, dh, dh) T
  const float* b0;      // (n_blocks, dh)
  const void* w1;       // (n_blocks, dh, dh) T
  const float* b1;      // (n_blocks, dh)
  const void* wo;       // (d_out, dh) T
  const float* bo;      // (d_out)
  const int* tables;    // (2, k_in): column mode (0 raw, 1 sin, 2 zero), source lane
  const float* fph;     // (2, k_in): frequency, phase
  float* out;           // (N, d_out)
  void* stash;          // nullptr, or (stash_slots, N, dh) T: every post-ReLU activation
  float* pool;          // bf16 wgmma forward, ns > 1: view sums, 64 x 256 H floats a tile
  int N, ns, d_in, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, activate;
};

constexpr int GOUT_W = 8;  // row width of the rounded output cotangent (d_out <= 8)

struct FcBwdArgs {
  const float* x;       // (ns, N, d_in) raw inputs
  const float* g;       // (N, d_out) output cotangent
  const void* stash;    // forward's activations
  const void* wiT;      // (k_in, dh) T, lin_in transposed, zero rows past d_enc
  const void* wzT;      // (n_lin_z, dl, dh) T
  const void* w0T;      // (n_blocks, dh, dh) T
  const void* w1T;      // (n_blocks, dh, dh) T
  const void* wo;       // (d_out, dh) T
  const float* bo;      // (d_out)
  const int* tables;    // (2, k_in)
  const float* fph;     // (2, k_in)
  float* dx;            // (ns, N, d_in)
  void* dz;             // (ns, N, dl) T
  void* cot;            // (cot_slots, N, dh) T: rounded cotangents of the products
  void* gout;           // (N, GOUT_W) T: rounded cotangent of lin_out's output
  void* enc;            // (ns, N, k_in) T: the encoded input, lin_in's operand
  float* pool;          // ns > 1: (N rounded up to the tile, dh) pooled trunk cotangent
  int N, ns, d_in, k_in, d_latent, d_hidden, d_out, n_blocks, n_lin_z, activate;
};


// The wgrad's reduction (csrc/resnetfc_hopper.cu resnetfc_wgrad_reduce_kernel),
// shared by the bf16 wgrad and the float32 one (csrc/resnetfc.cu): dW += the
// splits' partial tiles in split order and db += the bias partials, each
// job's partials at its offsets in `part` (ops/kernels/resnetfc.py
// wgrad_plan, WGRAD_PLAN_W values a job).
constexpr int WGRAD_PLAN_W = 13;
constexpr int MAX_RJOBS = 24;
struct ReduceJob {
  float* dW;
  float* db;
  long long part, bpart, first;  // first: the job's first element of the flat index
  int Mg, Ka, splits, bsplits;      // bias partials: splits x column tiles
};
struct ReduceArgs {
  ReduceJob job[MAX_RJOBS];
  int n_jobs;
  long long total;
};
int wgrad_reduce(const ReduceArgs& r, const float* part, cudaStream_t s);
