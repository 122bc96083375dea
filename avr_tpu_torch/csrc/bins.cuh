// The binned, owner-computed accumulation of a gather's latent cotangent
// (csrc/gather.cu launch_bins), as K3's backward calls it.
#pragma once

#include "common.cuh"

// dfeat (maps, H, W, C) = sum over (point, tap) of w * g (bf16: round(w);
// march_bins_f32: float32 g and dfeat, the float32 accumulate): the
// world points (maps / views, N, 3) projected into each map through its 16
// packed scalars proj (maps, 16), `views` consecutive maps sharing one
// point set and its cotangent rows g (maps / views, N, C).  float32 sums in
// a fixed order, written once; no float atomics.  `ints` and `partials`:
// ops/kernels/gather.py bin_workspace(maps, H, W, C, N).
void march_bins_bf16(const float* points, const float* proj, const bf16* g, bf16* dfeat,
                     void* ints, void* partials, int maps, int views, int H, int W, int C, int N,
                     cudaStream_t s);
void march_bins_f32(const float* points, const float* proj, const float* g, float* dfeat,
                    void* ints, void* partials, int maps, int views, int H, int W, int C, int N,
                    cudaStream_t s);
