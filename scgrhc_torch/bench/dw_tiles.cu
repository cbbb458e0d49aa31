// Times the f32 dw stage (conv3.cuh: dw_mma_kernel<DwWgTile>, the product
// on Hopper's warpgroup MMA) alone at the training step's layer shapes, N
// = 64 and 32: its rows copied by the TMA unit where the shape allows, and
// by cp.async (the path for tensors that are not 16-byte aligned: here dc
// and x 8 bytes past an alignment).  Each launch is stage 1 with the
// sample splits its plan takes (one wave: one block an SM), then
// dw_reduce_kernel; the time is of both.  Each result is held against
// float64 computed on the card (relative L2 error), and a second launch
// must give the same bits.  bf16 (DwMain on mma.sync, stage 1 alone) is
// timed at 256 -> 512.  Last, the launcher's host time a call (its two
// tensor maps and the launch) beside a plain launch's.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v \
//       -o build/dw_tiles scgrhc_torch/bench/dw_tiles.cu && build/dw_tiles
//
// Inputs are uniform in [-1.7, 1.7), from a fixed LCG.

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <vector>

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

// dw[o, i, k] = sum_{s, t} dc[s, o, t] * x[s, i, t + k - 1] in float64: a
// block per (o, i), its threads over (s, t), summed in a fixed order.
__global__ void ref64(const float* dc, const float* x, double* dw, int n, int cin, int cout,
                      int len) {
  __shared__ double red[3][256];
  const int o = blockIdx.x / cin, i = blockIdx.x % cin;
  double v[3] = {0.0, 0.0, 0.0};
  for (long long e = threadIdx.x; e < (long long)n * len; e += blockDim.x) {
    const int s = (int)(e / len), t = (int)(e % len);
    const double d = dc[((size_t)s * cout + o) * len + t];
    const float* xr = x + ((size_t)s * cin + i) * len;
    for (int k = 0; k < 3; ++k) {
      const int tt = t + k - 1;
      if (tt >= 0 && tt < len) v[k] += d * xr[tt];
    }
  }
  for (int k = 0; k < 3; ++k) red[k][threadIdx.x] = v[k];
  __syncthreads();
  if (threadIdx.x < 3) {
    double sum = 0.0;
    for (int j = 0; j < 256; ++j) sum += red[threadIdx.x][j];
    dw[(size_t)blockIdx.x * 3 + threadIdx.x] = sum;
  }
}

__global__ void to_bf16(const float* src, __nv_bfloat16* dst, size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) dst[i] = __float2bfloat16(src[i]);
}

void fill(std::vector<float>& v, unsigned seed) {
  unsigned s = seed;
  for (auto& e : v) {
    s = s * 1664525u + 1013904223u;
    e = ((s >> 8) * (1.0f / 16777216.0f) * 2.f - 1.f) * 1.7f;
  }
}

struct Case {
  int n, cin, cout, len;
  const float *dc, *x;
  float *part, *dw;
  const std::vector<double>* want;
};

// Stage 1 by launch, then the reduce; the time of both, the error against
// float64, and whether a repeat gives the same bits.
template <typename L>
void run(const char* name, const Case& c, int tiles, int blocks_per_wave, L stage1) {
  int nsplit = blocks_per_wave / tiles;
  nsplit = nsplit < 1 ? 1 : nsplit > c.n ? c.n : nsplit;
  const int count = c.cout * 3 * c.cin;
  auto launch = [&] {
    stage1(nsplit);
    dw_reduce_kernel<<<(count + kThreads - 1) / kThreads, kThreads>>>(
        c.part, c.dw, nullptr, c.cin, c.cout, 3 * c.cin, nsplit);
  };
  launch();
  cudaError_t err = cudaDeviceSynchronize();
  std::vector<float> got(count), again(count);
  cudaMemcpy(got.data(), c.dw, sizeof(float) * count, cudaMemcpyDeviceToHost);
  launch();
  cudaMemcpy(again.data(), c.dw, sizeof(float) * count, cudaMemcpyDeviceToHost);
  double num = 0.0, den = 0.0;
  for (int j = 0; j < count; ++j) {
    const double d = got[j] - (*c.want)[j];
    num += d * d;
    den += (*c.want)[j] * (*c.want)[j];
  }
  const float ms = time_ms(launch);
  if (err == cudaSuccess) err = cudaGetLastError();
  const double flops = 2.0 * c.cout * 3 * c.cin * c.n * (double)c.len;
  const double rate = flops / ms / 1e9;  // TFLOP/s
  printf("%-36s N=%2d C_in=%3d O=%3d T=%d nsplit %2d: %.4f ms, %.1f TFLOP/s (%.1f %% of 3xTF32), "
         "rel err %.3g, repeat %s  [%s]\n",
         name, c.n, c.cin, c.cout, c.len, nsplit, ms, rate, rate / (495.0 / 3) * 100,
         std::sqrt(num / den), std::memcmp(got.data(), again.data(), sizeof(float) * count) == 0
                                   ? "same bits" : "DIFFERENT BITS",
         cudaGetErrorString(err));
}

void run_wg(const char* name, const Case& c, const float* dc, const float* x) {
  run(name, c, dw_wg_tiles<DwWgTile>(c.cin, c.cout), kWgBlocks, [&](int nsplit) {
    launch_dw_wgmma<DwWgTile>(dc, x, c.part, c.n, c.cin, c.cout, c.len, nsplit, 0);
  });
}

// Host microseconds a call of f takes, over reps calls queued behind one
// another (the device busy with the earlier ones).
template <typename F>
double host_us(F f, int reps = 200) {
  f();
  cudaDeviceSynchronize();
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) f();
  const auto t1 = std::chrono::steady_clock::now();
  cudaDeviceSynchronize();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / reps;
}

int main() {
  const int shapes[][3] = {{3, 64, 750},    {4, 64, 750},    {5, 64, 750},   {64, 64, 750},
                           {64, 128, 748},  {128, 128, 748}, {128, 256, 746}, {256, 256, 746},
                           {256, 512, 744}, {512, 512, 744}, {512, 256, 746}, {256, 512, 750}};
  for (int n : {64, 32}) {
    for (const auto& sh : shapes) {
      const int cin = sh[0], cout = sh[1], len = sh[2];
      if (n == 32 && cin < 64) continue;
      std::vector<float> hdc((size_t)n * cout * len), hx((size_t)n * cin * len);
      fill(hdc, 1u + cin), fill(hx, 7u + cout);
      float *dc, *x, *part, *dw;
      double* want64;
      __nv_bfloat16* xb;
      cudaMalloc(&dc, sizeof(float) * hdc.size());
      cudaMalloc(&x, sizeof(float) * hx.size());
      float *dc8_base, *x8_base;
      cudaMalloc(&dc8_base, sizeof(float) * (hdc.size() + 2));
      cudaMalloc(&x8_base, sizeof(float) * (hx.size() + 2));
      float *dc8 = dc8_base + 2, *x8 = x8_base + 2;
      cudaMalloc(&xb, sizeof(__nv_bfloat16) * hx.size());
      cudaMalloc(&part, sizeof(float) * 264 * cout * 3 * cin);
      cudaMalloc(&dw, sizeof(float) * cout * 3 * cin);
      cudaMalloc(&want64, sizeof(double) * cout * 3 * cin);
      cudaMemcpy(dc, hdc.data(), sizeof(float) * hdc.size(), cudaMemcpyHostToDevice);
      cudaMemcpy(x, hx.data(), sizeof(float) * hx.size(), cudaMemcpyHostToDevice);
      to_bf16<<<(unsigned)((hx.size() + 255) / 256), 256>>>(x, xb, hx.size());
      const int count = cout * 3 * cin;
      ref64<<<cout * cin, 256>>>(dc, x, want64, n, cin, cout, len);
      std::vector<double> want(count);
      cudaMemcpy(want.data(), want64, sizeof(double) * count, cudaMemcpyDeviceToHost);
      const Case c{n, cin, cout, len, dc, x, part, dw, &want};
      run_wg("DwWgTile", c, dc, x);
      // the same values 8 bytes past a 16-byte boundary: cp.async, no TMA
      cudaMemcpy(dc8, dc, sizeof(float) * hdc.size(), cudaMemcpyDeviceToDevice);
      cudaMemcpy(x8, x, sizeof(float) * hx.size(), cudaMemcpyDeviceToDevice);
      run_wg("DwWgTile, cp.async rows", c, dc8, x8);
      if (cin == 256 && cout == 512) {
        const int main_tiles =
            (cout + DwMain::BM - 1) / DwMain::BM * ((cin + DwMain::BC - 1) / DwMain::BC);
        const int nsplit = 2 * kWgBlocks / main_tiles < n ? 2 * kWgBlocks / main_tiles : n;
        const float ms = time_ms([&] {
          launch_dw_mma<DwMain>(dc, xb, part, n, cin, cout, len, nsplit, 0);
        });
        printf("DwMain bf16, stage 1 alone N=%d 256->512 T=%d nsplit %d: %.4f ms  [%s]\n", n,
               len, nsplit, ms, cudaGetErrorString(cudaGetLastError()));
        if (n == 64) {
          const int wsplit = dw_plan(n, cin, cout, true).nsplit;
          CUtensorMap map;
          printf("host us a call, N=64 256->512 T=%d: launch_dw_wgmma %.2f, its two tensor "
                 "maps %.2f, a dw_reduce_kernel launch %.2f\n", len,
                 host_us([&] {
                   launch_dw_wgmma<DwWgTile>(dc, x, part, n, cin, cout, len, wsplit, 0);
                 }),
                 host_us([&] {
                   dw_tensor_map(&map, x, (long long)n * cin, len, 2, DwWgTile::kXCols);
                   dw_tensor_map(&map, dc, (long long)n * cout, len, 2, DwWgTile::kDCols);
                 }),
                 host_us([&] {
                   dw_reduce_kernel<<<(cout * 3 * cin + kThreads - 1) / kThreads, kThreads>>>(
                       part, dw, nullptr, cin, cout, 3 * cin, wsplit);
                 }));
        }
      }
      cudaFree(dc);
      cudaFree(x);
      cudaFree(dc8_base);
      cudaFree(x8_base);
      cudaFree(xb);
      cudaFree(part);
      cudaFree(dw);
      cudaFree(want64);
    }
  }
  return 0;
}
