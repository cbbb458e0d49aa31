// Times the f32 conv core (conv3.cuh: conv_mma_kernel<WgTile<...>>, the
// warpgroup-MMA product) alone: at the critic's layers (N = 32, T = 750)
// under WgChoice, the tiling the kernels use, and under the other tilings
// it was chosen from, for the conv (c = conv1d(x, w) + b) and the dx
// product (a conv over dc with w transposed and flipped), each with the
// weight split (conv_weight_split_kernel) timed on its own; then the
// in_relu forward (the core and row_kernel) at the generator's layers at
// serving's batch (N = 512, T = 750 .. 744).  Each result at N = 32 is
// held against float64 computed on the card (relative L2 error and
// largest absolute error); the N = 512 shapes are timed only.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/conv_core scgrhc_torch/bench/conv_core.cu && build/conv_core
//
// Inputs are uniform in [-1.7, 1.7) (x, dc) and in the layer's default
// init bound (w, b), from a fixed LCG.

#include <cmath>
#include <cstdio>
#include <vector>

#include "../csrc/conv3.cuh"

using namespace scgrhc;

// y[n, m, t] = (b[m] if b) + sum_i sum_k W(m, i, k) * src[n, i, t + k - 1]
// in float64, W(m, i, k) = w[m][i][k], or with transw w[i][m][2 - k].
__global__ void ref64(const float* src, const float* w, const float* b, double* y, int n,
                      int kdim, int mdim, int len, bool transw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n * mdim * len) return;
  const int t = (int)(i % len), m = (int)((i / len) % mdim);
  const size_t s = i / ((size_t)len * mdim);
  double v = b != nullptr ? b[m] : 0.0;
  for (int c = 0; c < kdim; ++c)
    for (int k = 0; k < 3; ++k) {
      const int tt = t + k - 1;
      const float wv = transw ? w[((size_t)c * mdim + m) * 3 + 2 - k]
                              : w[((size_t)m * kdim + c) * 3 + k];
      if (tt >= 0 && tt < len) v += (double)wv * src[(s * kdim + c) * len + tt];
    }
  y[i] = v;
}

template <typename F>
float time_ms(F launch, int reps = 20) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 3; ++i) launch();
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

// One product: out (n, cols, len) over src (n, kdim, len), its float64
// reference, and the split weights.
struct Case {
  int cin, cout;  // the layer's, for the labels
  int n, kdim, cols, len;
  bool transw;
  const float* src;
  const float* w;
  const float* b;
  float* y;
  float* ws;
  std::vector<double> want;
  std::vector<float> got;
  double gflop() const { return 6.0 * kdim * cols * len * n * 1e-9; }
  void report(const char* what, const char* name, float ms) {
    const cudaError_t e = cudaDeviceSynchronize();
    cudaMemcpy(got.data(), y, got.size() * 4, cudaMemcpyDeviceToHost);
    double num = 0, den = 0, mx = 0;
    for (size_t i = 0; i < got.size(); ++i) {
      const double d = got[i] - want[i];
      num += d * d;
      den += want[i] * want[i];
      mx = fmax(mx, fabs(d));
    }
    printf("%-4s %3d->%-3d %-34s %8.4f ms %6.1f TFLOP/s %5.1f %% of 3xTF32  rel L2 %.3g  "
           "max abs %.3g  %s\n",
           what, cin, cout, name, ms, gflop() / ms, 100.0 * gflop() / ms / 165.0,
           sqrt(num / fmax(den, 1e-300)), mx, cudaGetErrorString(e));
  }
};

ConvPlan plan_for(const Case& c, int bm, int bn) {
  ConvPlan p{kPathWgmma, dim3(0, 0, 0), dim3(cdiv(c.len, bm), cdiv(c.cols, bn), c.n), 0, 0,
             false};
  const long long tiles = (long long)p.tiles.x * p.tiles.y * p.tiles.z;
  p.grid = dim3((unsigned)(tiles < kWgBlocks ? tiles : kWgBlocks), 1, 1);
  return p;
}

// The product under the tiling Tile (the split weights made for its BN).
template <typename Tile>
void variant(Case& c, const char* what, const char* name) {
  const ConvPlan p = plan_for(c, Tile::BM, Tile::BN);
  launch_wsplit_bn<Tile::BN>(c.w, c.ws, c.kdim, c.cols, c.transw, 0);
  cudaMemset(c.y, 0, c.got.size() * 4);
  const float ms = time_ms([&] {
    launch_wgmma_tile<Tile>(p, c.src, c.ws, c.b, c.y, c.kdim, c.cols, c.len, false, 0);
  });
  c.report(what, name, ms);
}

// The launchers' own path: the split and the product, and the split alone.
void main_path(Case& c, const char* what) {
  const ConvPlan p = plan_for(c, wg_tile_m(c.cols), wg_tile_n(c.cols));
  cudaMemset(c.y, 0, c.got.size() * 4);
  const float ms = time_ms([&] {
    launch_wsplit(c.w, c.ws, c.kdim, c.cols, c.transw, 0);
    launch_conv_wgmma(p, c.src, c.ws, c.b, c.y, c.kdim, c.cols, c.len, false, 0);
  });
  c.report(what, "split + core (WgChoice)", ms);
  const float split = time_ms([&] { launch_wsplit(c.w, c.ws, c.kdim, c.cols, c.transw, 0); });
  printf("%-4s %3d->%-3d %-34s %8.4f ms (%.2f MB written)\n", what, c.cin, c.cout,
         "conv_weight_split_kernel alone", split, wsplit_numel(c.kdim, c.cols) * 4e-6);
}

// Uniform values in [-scale, scale) from a fixed LCG.
void fill(std::vector<float>& v, float scale, unsigned seed) {
  for (auto& e : v) {
    seed = seed * 1664525u + 1013904223u;
    e = ((seed >> 8) * (1.0f / 16777216.0f) * 2.f - 1.f) * scale;
  }
}

float* upload(const std::vector<float>& v) {
  float* p;
  cudaMalloc(&p, v.size() * 4);
  cudaMemcpy(p, v.data(), v.size() * 4, cudaMemcpyHostToDevice);
  return p;
}

// The in_relu forward (the split, the core into c, then row_kernel) at
// N = 512, timed only: the generator's layer at serving's batch.
float serving_layer(int cin, int cout, int len) {
  const int n = 512;
  std::vector<float> hx((size_t)n * cin * len), hw((size_t)cout * cin * 3), hb(cout);
  fill(hx, 1.7f, 12345u);
  fill(hw, 1.f / sqrtf(cin * 3.f), 777u);
  fill(hb, 1.f / sqrtf(cin * 3.f), 999u);
  float *x = upload(hx), *w = upload(hw), *b = upload(hb), *c, *y, *ws;
  const size_t ny = (size_t)n * cout * len;
  cudaMalloc(&c, ny * 4);
  cudaMalloc(&y, ny * 4);
  cudaMalloc(&ws, wsplit_numel(cin, cout) * 4);
  const ConvPlan p = conv_plan(n, cin, cout, len, kInRelu, kPassFwd, true);
  const double gflop = 6.0 * cin * cout * len * n * 1e-9;
  const float ms = time_ms([&] {
    launch_wsplit(w, ws, cin, cout, false, 0);
    launch_conv_wgmma(p, x, ws, b, c, cin, cout, len, false, 0);
    launch_row<float, kRowInReluFwd>(p.row_blocks, c, nullptr, y, n * cout, len, 0);
  }, 5);
  printf("in   %3d->%-3d N=512 T=%d split + core + row_kernel: %8.4f ms %6.1f TFLOP/s  %s\n",
         cin, cout, len, ms, gflop / ms, cudaGetErrorString(cudaGetLastError()));
  for (void* q : {(void*)x, (void*)w, (void*)b, (void*)c, (void*)y, (void*)ws}) cudaFree(q);
  return ms;
}

int main() {
  const int layers[][2] = {{4, 64}, {5, 64}, {64, 64}, {64, 128}, {128, 256}, {256, 512}};
  const int n = 32, len = 750;
  for (const auto& l : layers) {
    const int cin = l[0], cout = l[1];
    const size_t nx = (size_t)n * cin * len, ny = (size_t)n * cout * len;
    std::vector<float> hx(nx), hdc(ny), hw((size_t)cout * cin * 3), hb(cout);
    fill(hx, 1.7f, 12345u);
    fill(hdc, 1.7f, 4321u);
    fill(hw, 1.f / sqrtf(cin * 3.f), 777u);
    fill(hb, 1.f / sqrtf(cin * 3.f), 999u);
    float *x = upload(hx), *dc = upload(hdc), *w = upload(hw), *b = upload(hb), *y, *dx, *ws;
    double* r64;
    cudaMalloc(&y, ny * 4);
    cudaMalloc(&dx, nx * 4);
    // room for the widest tile's split weights of either product
    const long long nws = 2 * (wsplit_numel(cin, 128 * cdiv(cout, 128)) +
                               wsplit_numel(cout, 128 * cdiv(cin, 128)));
    cudaMalloc(&ws, nws * 4);
    cudaMalloc(&r64, (nx > ny ? nx : ny) * 8);
    Case fwd{cin, cout, n, cin, cout, len, false, x, w, b, y, ws,
             std::vector<double>(ny), std::vector<float>(ny)};
    ref64<<<(unsigned)((ny + 255) / 256), 256>>>(x, w, b, r64, n, cin, cout, len, false);
    cudaMemcpy(fwd.want.data(), r64, ny * 8, cudaMemcpyDeviceToHost);
    Case bwd{cin, cout, n, cout, cin, len, true, dc, w, nullptr, dx, ws,
             std::vector<double>(nx), std::vector<float>(nx)};
    ref64<<<(unsigned)((nx + 255) / 256), 256>>>(dc, w, nullptr, r64, n, cout, cin, len, true);
    cudaMemcpy(bwd.want.data(), r64, nx * 8, cudaMemcpyDeviceToHost);

    main_path(fwd, "fwd");
    variant<WgTile<128, 1, 8, 4>>(fwd, "fwd", "128 x 128 steps, 8 st, 4 producers");
    variant<WgTile<128, 1, 6, 4>>(fwd, "fwd", "128 x 128, 6 stages, 4 producers");
    variant<WgTile<128, 1, 8, 2>>(fwd, "fwd", "128 x 128, 8 stages, 2 producers");
    variant<WgTile<128, 1, 8, 1>>(fwd, "fwd", "128 x 128, 8 stages, 1 producer");
    variant<WgTile<64, 1, 8, 4>>(fwd, "fwd", "64 x 128 steps, 8 st, 4 producers");
    variant<WgTile<64, 2, 8, 4>>(fwd, "fwd", "64 x 256 steps, 8 st, 4 producers");
    if (cout <= 64) {
      variant<WgTile<32, 2, 8, 4>>(fwd, "fwd", "32 x 256 steps, 8 st, 4 producers");
      variant<WgTile<32, 1, 8, 4>>(fwd, "fwd", "32 x 128 steps, 8 st, 4 producers");
    }
    main_path(bwd, "dx");
    variant<WgTile<128, 1, 8, 4>>(bwd, "dx", "128 x 128 steps, 8 st, 4 producers");
    variant<WgTile<128, 1, 8, 1>>(bwd, "dx", "128 x 128, 8 stages, 1 producer");
    variant<WgTile<64, 1, 8, 4>>(bwd, "dx", "64 x 128 steps, 8 st, 4 producers");
    variant<WgTile<64, 2, 8, 4>>(bwd, "dx", "64 x 256 steps, 8 st, 4 producers");
    if (cin <= 8) {
      variant<WgTile<8, 1, 8, 4>>(bwd, "dx", "8 x 128 steps, 8 st, 4 producers");
      variant<WgTile<8, 2, 8, 4>>(bwd, "dx", "8 x 256 steps, 8 st, 4 producers");
    }
    for (void* p : {(void*)x, (void*)dc, (void*)w, (void*)b, (void*)y, (void*)dx, (void*)ws,
                    (void*)r64})
      cudaFree(p);
  }
  // the generator's 14 layers at serving's batch (11 distinct shapes)
  const int gen[][3] = {{4, 64, 750},    {64, 64, 750},   {64, 128, 748},  {128, 128, 748},
                        {128, 256, 746}, {256, 256, 746}, {256, 512, 744}, {512, 512, 744},
                        {512, 256, 746}, {256, 128, 748}, {128, 64, 750}};
  float total = 0.f;
  for (const auto& l : gen) total += serving_layer(l[0], l[1], l[2]);
  printf("the 11 distinct serving layers: %.3f ms\n", total);
  return 0;
}
