// Native ray-batch assembler for the host-side input pipeline.
//
// Assembles per-step training inputs (gathered pixel coords, per-ray
// cam2world, ground-truth colours) from a collated (SB, NV, sl^2, ...)
// scene batch, given precomputed flat ray indices — the hot inner loop of
// avr_tpu_torch.data.sampling.gather_rays, on the calling thread or, if
// asked, on a thread a scene.
// The Python side samples the indices (RNG stays in numpy, so this gather
// and its numpy twin give the same arrays bit for bit) and calls through
// ctypes; see avr_tpu_torch/data/native.py, which builds this file at first
// use (g++ -O3 -shared -fPIC -pthread) into avr_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct GatherArgs {
  const float* x_pix;      // (SB, NV*sl2, 2)
  const float* images;     // (SB, NV*sl2, 3)  in [-1, 1]
  const float* cam2world;  // (SB, NV, 16)
  const int64_t* rays_idx; // (SB, R) flat indices into NV*sl2
  float* out_x_pix;        // (SB, R, 2)
  float* out_c2w;          // (SB, R, 16)
  float* out_gt;           // (SB, R, 3)  in [0, 1]
  int64_t SB, NV, sl2, R;
};

void gather_scene_range(const GatherArgs& a, int64_t sb_begin, int64_t sb_end) {
  const int64_t P = a.NV * a.sl2;
  for (int64_t sb = sb_begin; sb < sb_end; ++sb) {
    const float* xp = a.x_pix + sb * P * 2;
    const float* im = a.images + sb * P * 3;
    const float* cw = a.cam2world + sb * a.NV * 16;
    const int64_t* idx = a.rays_idx + sb * a.R;
    float* ox = a.out_x_pix + sb * a.R * 2;
    float* oc = a.out_c2w + sb * a.R * 16;
    float* og = a.out_gt + sb * a.R * 3;
    for (int64_t r = 0; r < a.R; ++r) {
      const int64_t p = idx[r];
      const int64_t view = p / a.sl2;
      ox[r * 2 + 0] = xp[p * 2 + 0];
      ox[r * 2 + 1] = xp[p * 2 + 1];
      std::memcpy(oc + r * 16, cw + view * 16, 16 * sizeof(float));
      og[r * 3 + 0] = 0.5f * im[p * 3 + 0] + 0.5f;
      og[r * 3 + 1] = 0.5f * im[p * 3 + 1] + 0.5f;
      og[r * 3 + 2] = 0.5f * im[p * 3 + 2] + 0.5f;
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.
int avr_gather_rays(const float* x_pix, const float* images,
                    const float* cam2world, const int64_t* rays_idx,
                    float* out_x_pix, float* out_c2w, float* out_gt,
                    int64_t SB, int64_t NV, int64_t sl2, int64_t R,
                    int64_t num_threads) {
  if (SB <= 0 || NV <= 0 || sl2 <= 0 || R <= 0) return 1;
  GatherArgs args{x_pix, images, cam2world, rays_idx,
                  out_x_pix, out_c2w, out_gt, SB, NV, sl2, R};
  int64_t workers = num_threads > 0 ? num_threads : 1;
  if (workers > SB) workers = SB;
  if (workers <= 1) {
    gather_scene_range(args, 0, SB);
    return 0;
  }
  std::vector<std::thread> threads;
  const int64_t per = (SB + workers - 1) / workers;
  for (int64_t w = 0; w < workers; ++w) {
    const int64_t lo = w * per;
    const int64_t hi = lo + per < SB ? lo + per : SB;
    if (lo >= hi) break;
    threads.emplace_back([&args, lo, hi] { gather_scene_range(args, lo, hi); });
  }
  for (auto& t : threads) t.join();
  return 0;
}

// uint8 image decode: HWC uint8 -> [-1, 1] float32 (the dataset
// normalization, reference dataset.py:51), one serial loop.
int avr_decode_images(const uint8_t* src, float* dst, int64_t n) {
  if (n <= 0) return 1;
  // divide (not multiply-by-reciprocal): bit-identical to the numpy
  // twin `u8.astype(f32) / 127.5 - 1`
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
  }
  return 0;
}

}  // extern "C"
