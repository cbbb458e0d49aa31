// Times the tensor-core conv core (conv3.cuh: conv_mma_kernel) alone: at
// the critic's layers (N = 32, T = 750) under ConvTile, the tiling the
// kernels use, and under the other tilings of the f32 product it was
// chosen from, for the in_relu forward (the core and row_kernel), the conv
// (c = conv1d(x, w) + b) and the dx product (a conv over dc with w
// transposed and flipped; at 512 -> 1, where its K is 3 of one 16-channel
// slice, beside dx_stream_kernel, the kernels' path there); then the
// in_relu forward at the generator's layers at serving's batch (N = 512,
// T = 750 .. 744), f32 and bf16.  Each f32 result at N = 32 is held
// against float64 computed on the card (relative L2 error and largest
// absolute error); the N = 512 shapes are timed only.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o build/conv_core scgrhc_torch/bench/conv_core.cu && build/conv_core
//
// Inputs are uniform in [-1.7, 1.7) (x) and in the layer's default init
// bound (w, b), from a fixed LCG.

#include <cmath>
#include <cstdio>
#include <vector>

#include "../csrc/conv3.cuh"

using namespace scgrhc;

// A tiling of conv_mma_kernel's f32 product with ConvTile's members.
template <int BM_, int BN_, int BC_, int STAGES_, int WM_>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, BC = BC_, STAGES = STAGES_, WM = WM_;
  static constexpr int WN = kWarps / WM, kMI = BM / WM / 16, kNI = BN / WN / 8;
  static constexpr bool kF32 = true;
  static constexpr int kLdA = BC + 4, kLdX = BN + 8, kXCols = BN + 4;
  static constexpr int kAFloats = 3 * BM * kLdA, kStage = kAFloats + BC * kLdX;
  static constexpr int kSmemBytes = (int)sizeof(float) * STAGES * kStage;
  static_assert(kLdA % 8 == 4 && kLdX % 32 == 8 && kMI >= 1 && kNI >= 1, "F32Tile: bad shape");
};

// y[n, m, t] = (b[m] if b) + sum_i sum_k W(m, i, k) * src[n, i, t + k - 1]
// in float64, with W as conv_fill reads it (TRANSW: w[i][m][2 - k]).
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
      const float wv = transw ? w[((size_t)c * mdim + m) * 3 + 2 - k] : w[((size_t)m * kdim + c) * 3 + k];
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

struct Case {
  int cin, cout;  // the layer's, for the labels
  int n, kdim, mdim, len;
  const float* src;
  const float* w;
  const float* b;
  float* y;
  std::vector<double> want;
  std::vector<float> got;
  double gflop() const { return 6.0 * kdim * mdim * len * n * 1e-9; }
  void report(const char* what, const char* name, float ms) {
    const cudaError_t e = cudaGetLastError();
    cudaMemcpy(got.data(), y, got.size() * 4, cudaMemcpyDeviceToHost);
    double num = 0, den = 0, mx = 0;
    for (size_t i = 0; i < got.size(); ++i) {
      const double d = got[i] - want[i];
      num += d * d;
      den += want[i] * want[i];
      mx = fmax(mx, fabs(d));
    }
    printf("%-4s %3d->%-3d %-36s %8.4f ms %6.1f TFLOP/s  rel L2 vs f64 %.3g  max abs %.3g  %s\n",
           what, cin, cout, name, ms, gflop() / ms, sqrt(num / fmax(den, 1e-300)), mx,
           cudaGetErrorString(e));
  }
};

// Where the f32 product's time goes: conv_mma_kernel's loop with the
// TF32 split taken out (the f32 bits go to the tensor cores as they are,
// so the results are wrong and are not held): MMAS = 3 keeps the three
// products of 3xTF32, MMAS = 1 keeps one.
template <typename Tile, int MMAS>
__global__ void __launch_bounds__(kThreads, 2)
conv_nosplit(const float* __restrict__ src, const float* __restrict__ w,
             float* __restrict__ out, int kdim, int mdim, int len) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kMI = Tile::kMI, kNI = Tile::kNI, S = Tile::STAGES, kLdA = Tile::kLdA,
                kLdX = Tile::kLdX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int wr = warp % Tile::WM, wc = warp / Tile::WM;
  const int t0 = blockIdx.x * Tile::BN, m0 = blockIdx.y * Tile::BM, n = blockIdx.z;
  const float* srcn = src + (size_t)n * kdim * len;
  const int slices = (kdim + Tile::BC - 1) / Tile::BC;
  float acc[kMI][kNI][4] = {};
  for (int st = 0; st < S - 1; ++st) {
    if (st < slices)
      conv_fill<Tile, float, float, false, true>(smem + st * Tile::kStage, srcn, w,
                                                 st * Tile::BC, m0, t0, kdim, mdim, len);
    cp_async_commit();
  }
  for (int i = 0; i < slices; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (i + S - 1 < slices)
      conv_fill<Tile, float, float, false, true>(smem + (i + S - 1) % S * Tile::kStage, srcn, w,
                                                 (i + S - 1) * Tile::BC, m0, t0, kdim, mdim, len);
    cp_async_commit();
    const float* st = smem + i % S * Tile::kStage;
    const float* A = st + (wr * kMI * 16 + g) * kLdA;
    const float* X = st + Tile::kAFloats + wc * kNI * 8 + g + 1;
    float sl[kMI][kNI][4] = {};
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int kc = 0; kc < Tile::BC; kc += 8) {
        unsigned a[kMI][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          const float* r = A + tap * Tile::BM * kLdA + mi * 16 * kLdA + kc + q;
          a[mi][0] = __float_as_uint(r[0]);
          a[mi][1] = __float_as_uint(r[8 * kLdA]);
          a[mi][2] = __float_as_uint(r[4]);
          a[mi][3] = __float_as_uint(r[8 * kLdA + 4]);
        }
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) {
          const float* xr = X + (kc + q) * kLdX + ni * 8 + tap;
          const unsigned b0 = __float_as_uint(xr[0]), b1 = __float_as_uint(xr[4 * kLdX]);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
            for (int r = 0; r < MMAS; ++r) mma_tf32(sl[mi][ni], a[mi], b0, b1);
        }
      }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sl[mi][ni][e];
  }
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + (wr * kMI + mi) * 16 + g + 8 * h;
      if (m >= mdim) continue;
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int t = t0 + (wc * kNI + ni) * 8 + 2 * q;
        if (t < len) store2(out + ((size_t)n * mdim + m) * len + t, acc[mi][ni][2 * h],
                            acc[mi][ni][2 * h + 1]);
      }
    }
}

// Uniform values in [-scale, scale) from a fixed LCG.
void fill(std::vector<float>& v, float scale, unsigned seed) {
  for (auto& e : v) {
    seed = seed * 1664525u + 1013904223u;
    e = ((seed >> 8) * (1.0f / 16777216.0f) * 2.f - 1.f) * scale;
  }
}

// A device copy of v in f32 and in bf16.
void upload(const std::vector<float>& v, float** f, __nv_bfloat16** h) {
  std::vector<__nv_bfloat16> hb(v.size());
  for (size_t i = 0; i < v.size(); ++i) hb[i] = __float2bfloat16(v[i]);
  cudaMalloc(f, v.size() * 4);
  cudaMalloc(h, v.size() * 2);
  cudaMemcpy(*f, v.data(), v.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(*h, hb.data(), v.size() * 2, cudaMemcpyHostToDevice);
}

// The in_relu forward (the core into c, then row_kernel) at N = 512, f32
// and bf16, timed only: the generator's layer at serving's batch.
void serving_layer(int cin, int cout, int len) {
  const int n = 512;
  std::vector<float> hx((size_t)n * cin * len), hw((size_t)cout * cin * 3), hb(cout);
  fill(hx, 1.7f, 12345u);
  fill(hw, 1.f / sqrtf(cin * 3.f), 777u);
  fill(hb, 1.f / sqrtf(cin * 3.f), 999u);
  float *x, *w, *b, *c, *y;
  __nv_bfloat16 *xb, *wb, *bb, *yb;
  upload(hx, &x, &xb);
  upload(hw, &w, &wb);
  upload(hb, &b, &bb);
  const size_t ny = (size_t)n * cout * len;
  cudaMalloc(&c, ny * 4);
  cudaMalloc(&y, ny * 4);
  cudaMalloc(&yb, ny * 2);
  using Main = ConvTile<float>;
  const dim3 grid((len + Main::BN - 1) / Main::BN, (cout + Main::BM - 1) / Main::BM, n);
  const int rows = n * cout, row_blocks = (rows + kWarps - 1) / kWarps;
  const double gflop = 6.0 * cin * cout * len * n * 1e-9;
  const float ms = time_ms([&] {
    launch_conv_mma<float, float, float, false, false>(grid, x, w, b, c, cin, cout, len, 0);
    launch_row<float, kRowInReluFwd>(row_blocks, c, nullptr, y, rows, len, 0);
  }, 5);
  const float ms16 = time_ms([&] {
    launch_conv_mma<__nv_bfloat16, __nv_bfloat16, float, false, false>(grid, xb, wb, bb, c, cin,
                                                                       cout, len, 0);
    launch_row<__nv_bfloat16, kRowInReluFwd>(row_blocks, c, nullptr, yb, rows, len, 0);
  }, 5);
  printf("in   %3d->%-3d N=512 T=%d core + row_kernel: f32 %8.4f ms %6.1f TFLOP/s, bf16 "
         "%8.4f ms %6.1f TFLOP/s  %s\n",
         cin, cout, len, ms, gflop / ms, ms16, gflop / ms16,
         cudaGetErrorString(cudaGetLastError()));
  for (void* p : {(void*)x, (void*)w, (void*)b, (void*)c, (void*)y, (void*)xb, (void*)wb,
                  (void*)bb, (void*)yb})
    cudaFree(p);
}

template <int MMAS>
void nosplit(Case& c, const char* name) {
  using Tile = ConvTile<float>;
  const auto k = &conv_nosplit<Tile, MMAS>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  const dim3 grid((c.len + Tile::BN - 1) / Tile::BN, (c.mdim + Tile::BM - 1) / Tile::BM, c.n);
  const float ms =
      time_ms([&] { k<<<grid, kThreads, Tile::kSmemBytes>>>(c.src, c.w, c.y, c.kdim, c.mdim, c.len); });
  printf("fwd  %3d->%-3d %-36s %8.4f ms %6.1f TFLOP/s  (results not held)  %s\n", c.cin, c.cout,
         name, ms, c.gflop() / ms, cudaGetErrorString(cudaGetLastError()));
}

template <typename Tile, bool TRANSW>
void variant(Case& c, const char* what, const char* name) {
  const auto k = &conv_mma_kernel<Tile, float, float, float, TRANSW, false, true>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmemBytes);
  const dim3 grid((c.len + Tile::BN - 1) / Tile::BN, (c.mdim + Tile::BM - 1) / Tile::BM, c.n);
  cudaMemset(c.y, 0, c.got.size() * 4);
  const float ms = time_ms([&] {
    k<<<grid, kThreads, Tile::kSmemBytes>>>(c.src, c.w, c.b, c.y, c.kdim, c.mdim, c.len);
  });
  c.report(what, name, ms);
}

int main() {
  const int layers[][2] = {{5, 64}, {64, 128}, {128, 256}, {256, 512}, {512, 1}};
  const int n = 32, len = 750;
  for (const auto& l : layers) {
    const int cin = l[0], cout = l[1];
    const size_t nx = (size_t)n * cin * len, ny = (size_t)n * cout * len, nw = (size_t)cout * cin * 3;
    std::vector<float> hx(nx), hdc(ny), hw(nw), hb(cout);
    unsigned s = 12345;
    auto rnd = [&]() {
      s = s * 1664525u + 1013904223u;
      return (s >> 8) * (1.0f / 16777216.0f) * 2.f - 1.f;
    };
    for (auto& v : hx) v = rnd() * 1.7f;
    for (auto& v : hdc) v = rnd() * 1.7f;
    const float bd = 1.f / sqrtf(cin * 3.f);
    for (auto& v : hw) v = rnd() * bd;
    for (auto& v : hb) v = rnd() * bd;
    float *x, *dc, *w, *b, *y, *c, *dx;
    double* r64;
    __nv_bfloat16 *xb, *wb, *bb, *yb;
    cudaMalloc(&x, nx * 4);
    cudaMalloc(&dc, ny * 4);
    cudaMalloc(&w, nw * 4);
    cudaMalloc(&b, cout * 4);
    cudaMalloc(&y, ny * 4);
    cudaMalloc(&c, ny * 4);
    cudaMalloc(&dx, nx * 4);
    cudaMalloc(&r64, (nx > ny ? nx : ny) * 8);
    cudaMalloc(&xb, nx * 2);
    cudaMalloc(&wb, nw * 2);
    cudaMalloc(&bb, cout * 2);
    cudaMalloc(&yb, ny * 2);
    cudaMemcpy(x, hx.data(), nx * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(dc, hdc.data(), ny * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(w, hw.data(), nw * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(b, hb.data(), cout * 4, cudaMemcpyHostToDevice);
    cudaMemset(xb, 0, nx * 2);
    cudaMemset(wb, 0, nw * 2);
    cudaMemset(bb, 0, cout * 2);

    Case fwd{cin, cout, n, cin, cout, len, x, w, b, y, std::vector<double>(ny), std::vector<float>(ny)};
    ref64<<<(unsigned)((ny + 255) / 256), 256>>>(x, w, b, r64, n, cin, cout, len, false);
    cudaMemcpy(fwd.want.data(), r64, ny * 8, cudaMemcpyDeviceToHost);
    // the in_relu layer in float64 on the float64 conv: one-pass biased statistics
    Case inr{cin, cout, n, cin, cout, len, x, w, b, y, fwd.want, std::vector<float>(ny)};
    for (size_t r = 0; r < (size_t)n * cout; ++r) {
      double* row = inr.want.data() + r * len;
      double s1 = 0, s2 = 0;
      for (int t = 0; t < len; ++t) s1 += row[t], s2 += row[t] * row[t];
      const double mean = s1 / len, var = fmax(s2 / len - mean * mean, 0.0);
      for (int t = 0; t < len; ++t) row[t] = fmax((row[t] - mean) / sqrt(var + 1e-5), 0.0);
    }
    Case bwd{cin, cout, n, cout, cin, len, dc, w, nullptr, dx, std::vector<double>(nx), std::vector<float>(nx)};
    ref64<<<(unsigned)((nx + 255) / 256), 256>>>(dc, w, nullptr, r64, n, cout, cin, len, true);
    cudaMemcpy(bwd.want.data(), r64, nx * 8, cudaMemcpyDeviceToHost);

    using Main = ConvTile<float>;
    const dim3 gf((len + Main::BN - 1) / Main::BN, (cout + Main::BM - 1) / Main::BM, n);
    const dim3 gd((len + Main::BN - 1) / Main::BN, (cin + Main::BM - 1) / Main::BM, n);
    float ms;
    if (cout >= kConvStreamBelow) {  // at 512 -> 1 the forward streams (conv_stream_kernel)
      // the in_relu forward: the core and the row pass
      const int rows = n * cout, row_blocks = (rows + kWarps - 1) / kWarps;
      ms = time_ms([&] {
        launch_conv_mma<float, float, float, false, false>(gf, x, w, b, c, cin, cout, len, 0);
        launch_row<float, kRowInReluFwd>(row_blocks, c, nullptr, y, rows, len, 0);
      });
      inr.report("in", "conv_mma_kernel + row_kernel, in_relu", ms);
      // the conv alone
      ms = time_ms([&] {
        launch_conv_mma<float, float, float, false, false>(gf, x, w, b, y, cin, cout, len, 0);
      });
      fwd.report("fwd", "conv_mma_kernel 64x128x16, 3 stages", ms);
      ms = time_ms([&] {
        launch_conv_mma<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false, false>(
            gf, xb, wb, bb, yb, cin, cout, len, 0);
      });
      printf("fwd  %3d->%-3d %-36s %8.4f ms %6.1f TFLOP/s\n", cin, cout,
             "conv_mma_kernel bf16", ms, fwd.gflop() / ms);
      nosplit<3>(fwd, "no TF32 split, 3 products");
      nosplit<1>(fwd, "no TF32 split, 1 product");
      variant<F32Tile<64, 128, 16, 4, 2>, false>(fwd, "fwd", "64x128x16, 4 stages");
      variant<F32Tile<64, 64, 16, 3, 2>, false>(fwd, "fwd", "64x64x16, 3 stages");
      variant<F32Tile<128, 64, 16, 3, 4>, false>(fwd, "fwd", "128x64x16, 3 stages");
      variant<F32Tile<128, 128, 16, 3, 2>, false>(fwd, "fwd", "128x128x16, 3 stages");
      variant<F32Tile<64, 128, 32, 3, 2>, false>(fwd, "fwd", "64x128x32, 3 stages");
    }

    if (cout < kConvStreamBelow) {
      ms = time_ms([&] {
        launch_dx_stream<float>(dim3((len + kStreamSteps - 1) / kStreamSteps, n), dc, w, dx, cin,
                                cout, len, 0);
      });
      bwd.report("dx", "dx_stream_kernel", ms);
    }
    // dx on the core (at 512 -> 1, K = 3 of one 16-channel slice)
    ms = time_ms([&] {
      launch_conv_mma<float, float, float, true, false>(gd, dc, w, nullptr, dx, cout, cin, len, 0);
    });
    bwd.report("dx", "conv_mma_kernel 64x128x16, 3 stages", ms);
    variant<F32Tile<64, 64, 16, 3, 2>, true>(bwd, "dx", "64x64x16, 3 stages");
    variant<F32Tile<128, 64, 16, 3, 4>, true>(bwd, "dx", "128x64x16, 3 stages");
    for (void* p : {(void*)x, (void*)dc, (void*)w, (void*)b, (void*)y, (void*)c, (void*)dx, (void*)r64,
                    (void*)xb, (void*)wb, (void*)bb, (void*)yb})
      cudaFree(p);
  }
  // the generator's 14 layers at serving's batch (11 distinct shapes)
  const int gen[][3] = {{4, 64, 750},    {64, 64, 750},   {64, 128, 748},  {128, 128, 748},
                        {128, 256, 746}, {256, 256, 746}, {256, 512, 744}, {512, 512, 744},
                        {512, 256, 746}, {256, 128, 748}, {128, 64, 750}};
  for (const auto& l : gen) serving_layer(l[0], l[1], l[2]);
  return 0;
}
