// Times the tensor-core dw stage (conv3.cuh: dw_mma_kernel) alone under
// several tilings, at the main path's shapes (N = 32), f32 and bf16, with
// the samples split for one or two blocks per SM.  DwMain is the tiling the
// kernels use; the others are the alternatives it was chosen from.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/dw_tiles scgrhc_torch/bench/dw_tiles.cu && build/dw_tiles
//
// Inputs are zeros: the time does not depend on the values.

#include <cstdio>
#include <initializer_list>

#include "../csrc/conv3.cuh"

using namespace scgrhc;

template <typename F>
float time_ms(F launch, int reps = 20) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  launch();
  launch();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms / reps;
}

template <typename Tile>
void run(const char* name, int n, int cin, int cout, int len, const float* dc, const float* x,
         const __nv_bfloat16* xb, float* part) {
  const int tiles = (cout + Tile::BM - 1) / Tile::BM * ((cin + Tile::BC - 1) / Tile::BC);
  const double flops = 2.0 * cout * 3 * cin * n * (double)len;
  for (int per_sm : {1, 2}) {
    int nsplit = 132 * per_sm / tiles;
    nsplit = nsplit < 1 ? 1 : nsplit > n ? n : nsplit;
    const float f32 = time_ms([&] {
      launch_dw_mma<Tile, float>(dc, x, part, n, cin, cout, len, nsplit, 0);
    });
    const float bf16 = time_ms([&] {
      launch_dw_mma<Tile, __nv_bfloat16>(dc, xb, part, n, cin, cout, len, nsplit, 0);
    });
    printf("%-34s C_in=%3d O=%3d T=%d nsplit %2d (%3d blocks): f32 %.4f ms (%.1f TFLOP/s), "
           "bf16 %.4f ms  [%s]\n", name, cin, cout, len, nsplit, tiles * nsplit, f32,
           flops / f32 / 1e9, bf16, cudaGetErrorString(cudaGetLastError()));
  }
}

int main() {
  const int n = 32;
  const int shapes[][3] = {{64, 128, 750}, {128, 256, 750}, {256, 512, 750}, {512, 512, 744}};
  for (const auto& sh : shapes) {
    const int cin = sh[0], cout = sh[1], len = sh[2];
    float *dc, *x, *part;
    __nv_bfloat16* xb;
    cudaMalloc(&dc, sizeof(float) * n * cout * len);
    cudaMalloc(&x, sizeof(float) * n * cin * len);
    cudaMalloc(&xb, sizeof(__nv_bfloat16) * n * cin * len);
    cudaMalloc(&part, sizeof(float) * n * cout * 3 * cin);
    cudaMemset(dc, 0, sizeof(float) * n * cout * len);
    cudaMemset(x, 0, sizeof(float) * n * cin * len);
    cudaMemset(xb, 0, sizeof(__nv_bfloat16) * n * cin * len);
    run<DwMain>("DwMain 64x32, 64 steps", n, cin, cout, len, dc, x, xb, part);
    run<DwTile<64, 32, 32, 3, 2, 2>>("64x32, 32 steps", n, cin, cout, len, dc, x, xb, part);
    run<DwTile<64, 64, 32, 3, 2, 2>>("64x64, 32 steps", n, cin, cout, len, dc, x, xb, part);
    run<DwTile<128, 32, 32, 3, 4, 1>>("128x32, 32 steps, 1 block/SM", n, cin, cout, len, dc, x,
                                      xb, part);
    run<DwTile<128, 64, 32, 3, 4, 1>>("128x64, 32 steps, 1 block/SM", n, cin, cout, len, dc, x,
                                      xb, part);
    cudaFree(dc);
    cudaFree(x);
    cudaFree(xb);
    cudaFree(part);
  }
  return 0;
}
